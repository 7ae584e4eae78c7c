import os

# Tests run against the single real CPU device (no fake-device override here:
# the 512-device mesh belongs exclusively to launch/dryrun.py, which sets
# XLA_FLAGS before jax initializes).  Distributed semantics are unit-tested on
# 1-device meshes; multi-device behaviour is exercised via subprocess tests
# that launch dryrun.py.
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "kernel_gate: interpret-mode fused wave-peel kernel equivalence "
        "gate (CI runs `-m kernel_gate` with REPRO_KERNEL_GATE=1 for the "
        "widened sweep; the tests also run in plain tier-1)")
    config.addinivalue_line(
        "markers",
        "cache_gate: TTI core-cache equivalence gate (CI runs "
        "`-m cache_gate` with REPRO_CACHE_GATE=1 for the widened fuzz "
        "seeds; the tests also run in plain tier-1)")
    config.addinivalue_line(
        "markers",
        "dist_gate: sharded-pipeline equivalence gate (CI runs "
        "`-m dist_gate` with REPRO_DIST_GATE=1 for the widened "
        "multi-mesh sweep; the tests also run in plain tier-1)")
    config.addinivalue_line(
        "markers",
        "wal_gate: write-ahead-journal durability gate — kill-anywhere "
        "crash recovery must be bit-identical (CI runs `-m wal_gate` "
        "with REPRO_WAL_GATE=1 for the every-record kill sweep; the "
        "tests also run, sampled, in plain tier-1)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (and nvcc for the port's kernels); "
        "skips with a reason where torch sees no CUDA device.  On the card: "
        "`python -m pytest -m cuda tests/test_torch_*.py`")
