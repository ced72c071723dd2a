"""utils/config.py wiring: backend override + perf timers (SURVEY §5
config/metrics rows — the HE_QAT_PERF analog must actually fire)."""

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.utils import config as cfg


def test_backend_override_via_config():
    old = cfg.get_config()
    try:
        cfg.set_config(cfg.Config(backend="xla"))
        from pailliercryptolib_tpu.ops.dispatch import default_backend

        assert default_backend() == "xla"
    finally:
        cfg.set_config(old)


def test_perf_timer_prints_when_enabled(capsys):
    old = cfg.get_config()
    try:
        cfg.set_config(cfg.Config(backend="xla", perf=True))
        key = ptpu.generate_keypair(256, enable_DJN=True)
        ct = key.pub_key.encrypt(ptpu.PlainText([1, 2]))
        assert key.priv_key.decrypt(ct).texts == [1, 2]
        out = capsys.readouterr().out
        assert "[paillier-tpu perf] encrypt_djn[B=2]" in out
        assert "[paillier-tpu perf] decrypt_crt[B=2]" in out
        assert "[paillier-tpu perf] download[B=2]" in out
    finally:
        cfg.set_config(old)


def test_perf_timer_silent_by_default(capsys):
    old = cfg.get_config()
    try:
        cfg.set_config(cfg.Config(backend="xla", perf=False))
        key = ptpu.generate_keypair(256, enable_DJN=True)
        key.pub_key.encrypt(ptpu.PlainText([3]))
        assert "[paillier-tpu perf]" not in capsys.readouterr().out
    finally:
        cfg.set_config(old)


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache path as given."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cfg.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default(monkeypatch):
    """Unset: the fixed <checkout>/.jax_cache beside the package."""
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cfg.compile_cache_dir() == os.path.join(repo, ".jax_cache")
