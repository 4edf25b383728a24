"""Test configuration: run numerics tests on CPU in float64 with a
virtual 8-device mesh for multi-chip sharding tests (the reference's
tests run on 1 MPI rank; we close that gap with simulated meshes, see
SURVEY.md §4).

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on a
machine with one, run them with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import os

os.environ.setdefault("FLUCA_TPU_DTYPE", "float64")

import jax

_platform = os.environ.get("JAX_PLATFORMS") or "cpu"
jax.config.update("jax_platforms", _platform)
if _platform == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


# ----------------------------------------------------------------------
# quick/slow split: `pytest -m "not slow"` is the inner-loop subset
# (~8 min); the full suite (~32 min) runs the physics regressions too.
# Tests measured >= ~15 s on the 2026-08-20 full run are marked here
# (one place, instead of scattering decorators).
# ----------------------------------------------------------------------
import pytest

_SLOW = {
    "test_fast_path_3d_smoke",
    "test_fast_path_matches_production_tgv",
    "test_fast_path_divergence_free",
    "test_production_budget_at_production_size",
    "test_each_fast_component_alone",
    "test_ns_shard_advance_matches_single_device",
    "test_capped3_matches_full_accuracy",
    "test_capped3_second_order",
    "test_production_preset_accuracy",
    "test_strouhal_regression",
    "test_two_process_sharded_checkpoint",
    "test_determinism_same_bits",
    "test_shard_local_checkpoint_load_virtual",
    "test_sphere_flow_smoke",
    "test_checkpoint_restart_bitwise_continuation",
    "test_tgv_second_order_convergence",
    "test_app_cgns_restart_flags",
    "test_tgv_divergence_free",
    "test_tgv3d_second_order_rate",
    "test_advance_matches_stepwise",
    "test_advance_monitor_interval",
    "test_ns_converged_reasons",
    "test_cavity_ghia_re100_64",
    "test_stretched_channel_fixed_budget_solvers",
    "test_high_cfl_richardson_fenced",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: physics/compile-heavy test (full suite only)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)"
    )


@pytest.fixture
def gpu():
    """Skip the test unless JAX runs on a GPU. Decided when the test
    runs, never at import: every xdist worker must collect the same
    tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest tests -m gpu")


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW:
            item.add_marker(pytest.mark.slow)
