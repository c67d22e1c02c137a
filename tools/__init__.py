"""Scripts that measure the port on the card, and the modules they share."""
