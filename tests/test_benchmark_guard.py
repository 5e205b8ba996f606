"""Timing-integrity guard (utils.benchmark.timed_run), the per-device
peak table it reads, and the compile-cache helper.

A benchmark artifact once recorded a wall 320x too fast because a
hand-rolled scalar fence leaked.  These tests pin the guard that fronts
every measurement: a synthetic wall implying ~100x the HBM roofline must be
rejected outright, a physically plausible one accepted.
"""
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ccqppy_jax.utils.benchmark import (PEAK_HBM_BYTES_PER_S, TimedRun,
                                        card_info, dense_sweep_bytes,
                                        materialize, peak_hbm_bytes_per_s,
                                        timed_run, use_compile_cache)

H100 = "NVIDIA H100 80GB HBM3"
PEAK = PEAK_HBM_BYTES_PER_S[H100]


def test_materialize_covers_every_leaf():
    tree = {"a": jnp.arange(4.0), "b": (jnp.ones((2, 2)), jnp.int32(3)),
            "c": jnp.array([True, False])}
    # 0+1+2+3 floats + 4 ones + int 3 + bool sum 1
    assert materialize(tree) == pytest.approx(6.0 + 4.0 + 3 + 1)


def test_guard_rejects_physically_impossible_wall():
    # An instant function claiming to have moved 1 PB: implied bandwidth
    # ~1e6 GB/s >> 2x the H100's 3.35 TB/s -> every rep rejected -> refuse
    # to report.
    fn = lambda x: x + 1
    with pytest.raises(RuntimeError, match="roofline"):
        timed_run(fn, jnp.zeros(8), reps=3, implied_bytes=1e15,
                  peak_bytes_per_s=PEAK)


def test_guard_rejects_100x_inflation_of_a_real_workload():
    # The historical failure shape: B=1024 n=999 at ~41 sweeps -> ~168 GB.
    # A 1.9 ms wall (the false committed number) implies ~88 TB/s.
    bytes_ = dense_sweep_bytes(1024, 999, 41)
    assert bytes_ / 0.0019 > 2 * PEAK           # the false wall IS absurd
    fn = lambda x: x * 2.0
    with pytest.raises(RuntimeError):
        timed_run(fn, jnp.zeros(16), reps=2, implied_bytes=bytes_,
                  peak_bytes_per_s=PEAK)


def test_plausible_measurement_accepted():
    x = jnp.arange(1000.0)
    out = timed_run(lambda v: jnp.cumsum(v), x, reps=2, implied_bytes=8000,
                    peak_bytes_per_s=PEAK)
    assert isinstance(out, TimedRun)
    assert out.wall_s > 0 and len(out.walls) == 2 and not out.rejected
    assert np.asarray(out.result).shape == (1000,)
    assert out.implied_gbps is not None


def test_make_args_threads_fresh_inputs():
    seen = []

    def make(rep):
        seen.append(rep)
        return (jnp.full(4, float(rep)),)

    out = timed_run(lambda v: v + 1, reps=2, make_args=make)
    assert seen == [-1, 0, 1]                   # warmup + 2 reps
    np.testing.assert_allclose(np.asarray(out.result), 2.0)


def test_fence_callable_defers_full_materialization():
    calls = {"fence": 0}

    def fence(out):
        calls["fence"] += 1
        return jnp.sum(out)

    res = timed_run(lambda v: v * 3.0, jnp.arange(8.0), reps=2, fence=fence)
    assert calls["fence"] == 2              # per timed rep (warmup is full)
    # the returned result is still the real full output, host-verified
    np.testing.assert_allclose(np.asarray(res.result), np.arange(8.0) * 3)


def test_peak_table_h100():
    """The H100 SXM's data-sheet HBM bandwidth, by its device_kind."""
    assert peak_hbm_bytes_per_s(H100) == 3.35e12


def test_peak_table_unknown_kind_raises():
    with pytest.raises(ValueError, match="no peak HBM bandwidth"):
        peak_hbm_bytes_per_s("Unlisted Accelerator")
    # The test run's own device (CPU) is not in the table either.
    with pytest.raises(ValueError):
        peak_hbm_bytes_per_s()


def test_guard_without_peak_uses_device_table():
    """With implied bytes and no explicit peak, timed_run asks the table
    for the running device — an unknown device raises, never a default."""
    with pytest.raises(ValueError, match="no peak HBM bandwidth"):
        timed_run(lambda v: v + 1, jnp.zeros(4), reps=1, implied_bytes=16)


def test_card_info_refuses_non_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        card_info()


def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert use_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = use_compile_cache()
        repo = pathlib.Path(__file__).resolve().parent.parent
        assert path == str(repo / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert use_compile_cache() == path        # fixed, not per call
        ignored = (repo / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
