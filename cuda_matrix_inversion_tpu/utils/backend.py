"""Backend pinning for the CLIs.

``--backend cpu`` pins JAX to the CPU through the config API
(``jax.config.update("jax_platforms", "cpu")``) before any device touch,
for runs that must not use the accelerator; ``auto`` leaves the choice
to JAX.
"""

from __future__ import annotations


def backend_argument(parser) -> None:
    """Add the standard ``--backend`` flag to an argparse parser."""
    parser.add_argument(
        "--backend", default="auto", choices=["auto", "cpu"],
        help="auto = whatever JAX picks (the GPU when one is present); "
             "cpu = pin the CPU backend")


def pin_backend(backend: str) -> None:
    """Apply the backend pin. Must run before any jax device touch."""
    if backend in (None, "auto"):
        return
    import jax

    jax.config.update("jax_platforms", backend)
