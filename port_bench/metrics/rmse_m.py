"""RMSE of the final mean field (``interp_smth``) against the benchmark's
synthetic truth, over every active cell of the window's days: the map's
accuracy, computed by the benchmark from the outputs."""


def read(run):
    return run.rmse_m()
