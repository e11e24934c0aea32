"""chip_smoke.py at a tiny size on the CPU backend, and its refusal to run
without a GPU. The card run is the same code at deployment size."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as C

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    """A tiny smoke run whose spec_encode phase already ran (later phases
    take its stream); the device RD gate is lowered to reach the device
    program at this size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
        s = C.Smoke(ref=jax.devices("cpu")[0], card="cpu test",
                    photo=(200, 136), hd=(96, 64), grid=(64, 2))
        s.spec_result = C.phase_spec_encode(s)
        yield s


def test_spec_encode_phase(smoke):
    r = smoke.spec_result
    assert r["failed"] == []
    assert r["device_rd_calls"] == [True]
    assert r["tables"]["satd_mismatches"] == 0
    assert r["decoded_equals_mirror"]


@pytest.mark.parametrize("phase", ["batch", "rgb", "native", "grid"])
def test_phase_on_cpu(smoke, phase, monkeypatch):
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
    res = getattr(C, f"phase_{phase}")(smoke)
    assert res["failed"] == []


def test_mesh_phase_on_four_virtual_devices(smoke):
    from libavif_tpu.parallel.shard import make_codec_mesh

    res = C.phase_mesh(smoke, make_codec_mesh(4))
    assert res["failed"] == []
    assert res["devices"] == 4
    assert all(res[k]["identical"] for k in ("hd", "photo", "grid"))


def test_main_refuses_cpu(capsys):
    assert C.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_script_alone_fails(tmp_path):
    """Copied out of the checkout, the script cannot import the engine and
    must fail without printing a result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    from libavif_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_ignored_checkout_dir(monkeypatch):
    from libavif_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = pathlib.Path(compile_cache.cache_dir())
    assert d == ROOT / ".jax_cache"
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    from libavif_tpu.utils import compile_cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
