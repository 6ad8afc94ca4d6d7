"""The paper's outer loop in the port: probes, gradients, Adam, fit, predict.

``init_hypers_heuristic`` (the large-dataset initialisation) is exported
here as in the reference. It is resolved on first access:
``repro_torch.core.driver`` imports ``repro_torch.checkpoint``, which
imports this package's modules, so an eager import here would be
circular.
"""


def __getattr__(name: str):
    if name == "init_hypers_heuristic":
        from repro_torch.core.driver import init_hypers_heuristic

        return init_hypers_heuristic
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
