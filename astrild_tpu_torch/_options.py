"""The JAX package's option spellings, accepted by the port.

The port names its options after what runs ("kernel", "plain"); the JAX
package names them after its backends ("pallas", "xla"). Each entry point
that takes such an option passes it through `port_spelling`, so code
written for the JAX package keeps working.
"""
from __future__ import annotations

__all__ = ["port_spelling"]


def port_spelling(value, aliases: dict, what: str):
    """`value` in the port's spelling: `aliases` maps the JAX package's
    spellings to the port's; anything else passes through for the caller
    to validate. The `*_interpret` spellings raise: they select Pallas's
    interpret mode, which a CUDA kernel does not have."""
    if isinstance(value, str) and value.endswith("_interpret"):
        raise ValueError(
            f"{what}={value!r}: the port has no interpret mode (a CUDA "
            f"kernel runs only on the card); on a CPU tensor the plain "
            f"version runs, so pass {what}=None or the plain spelling")
    return aliases.get(value, value)
