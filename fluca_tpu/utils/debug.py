"""Debug / sanity checking.

The reference relies on PETSc debug-mode argument checking and
NSCheckDiverged (nsbasic.c:425-436); the JAX equivalents here:
field-level finiteness checks, a divergence (continuity residual)
probe, and jax_debug_nans toggling (SURVEY.md §5 'race detection /
sanitizers' translation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def state_finite(state) -> bool:
    """True iff every field in the NS state is finite."""
    leaves = jax.tree_util.tree_leaves(state)
    return all(bool(jnp.all(jnp.isfinite(x))) for x in leaves)


def check_state_finite(state, where: str = "") -> None:
    if not state_finite(state):
        bad = [
            path
            for path, x in jax.tree_util.tree_leaves_with_path(state)
            if not bool(jnp.all(jnp.isfinite(x)))
        ]
        raise FloatingPointError(
            f"non-finite fields {bad} {('at ' + where) if where else ''}"
        )


def continuity_residual(ns) -> float:
    """max |D U| — the discrete continuity violation."""
    div = ns.impl.ops.apply_D(ns.state["U"])
    return float(jnp.max(jnp.abs(div)))


def enable_nan_checks(on: bool = True) -> None:
    """Trap NaN production inside jitted code (jax_debug_nans)."""
    jax.config.update("jax_debug_nans", on)


def monitor_check_finite(ns) -> None:
    """Monitor hook: raise on non-finite state (add with
    ns.add_monitor)."""
    check_state_finite(ns.state, where=f"step {ns.step_index}")
