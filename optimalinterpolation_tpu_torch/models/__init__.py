"""Models of the port: the exact GP, its batched optimizer (L-BFGS or Adam),
the single-cell Nystrom and SVGP models and the BFGS of the ``cell``
command. The names below are imported on first use (``ops`` imports
``models.exact_gp``, and ``models.optimizer`` imports ``ops``)."""

import importlib

_EXPORTS = {
    "exact_gp": ("HYPER_INIT_LOG", "PredictResult", "neg_log_marginal_likelihood", "predict"),
    "optimizer": ("OptimizeConfig", "OptimizeResult", "optimize_mll", "optimize_mll_batch"),
    "nystroem": ("nystroem_nll", "nystroem_predict"),
    "svgp": ("SVGPConfig", "svgp_fit", "svgp_init", "svgp_predict"),
    "bfgs": ("minimize",),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name in _MODULE_OF:
        return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
