"""PyTorch/CUDA port of the iterative-GP system in ``repro``.

The package mirrors ``src/repro`` module for module; the JAX package stays
the reference that the port is tested against. The port imports ``torch``,
``numpy`` and the standard library only — never ``jax`` and nothing of
``repro``. Its distance-tile MVM and the backward of it (the
hyper-gradient) are hand-written CUDA kernels for Hopper
(``csrc/kernel_mvm.cu``, ``csrc/kernel_mvm_bwd.cu``); on CPU tensors every
wrapper runs its plain PyTorch version instead.

Entry points default to ``device="cuda"`` and raise when no card is
present; only an explicit ``device="cpu"`` runs on the CPU.
"""

__all__ = ["__version__", "resolve_device"]

__version__ = "1.0.0"


def __getattr__(name):
    # Imported at first use, so the stdlib-only ``repro_torch.analysis``
    # (the port's lint suite) imports without torch.
    if name == "resolve_device":
        from repro_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
