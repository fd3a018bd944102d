"""The port's serving path against the JAX package's.

``repro_torch.models.Model`` and ``repro_torch.serving.ServeEngine`` run
the JAX ``Model.init`` weights (carried across by ``repro_torch.interop``)
on the same numpy-seeded tokens as ``repro.models.model.Model`` and
``repro.serving.engine.ServeEngine``, for the dense smoke configs:
granite-3-2b, chatglm3-6b (partial RoPE), mistral-nemo-12b (explicit
head_dim) and gemma3-27b (sliding window 64, ring caches).  On the CPU the
port's RMSNorm and attention take their plain versions, where the JAX
model computes the same functions in jnp.

Tolerances:
 * float32: prefill logits, decode logits and the prefill cache within
   ``1e-5`` of the largest absolute value (the two frameworks sum in
   another order; the measured gap is ~1e-6), greedy tokens equal;
 * bfloat16: logits within ``5e-2`` of the largest absolute value.  The
   JAX decode step rounds the scaled query and the normalised
   probabilities to bf16 before its two products, where the port's decode
   attention keeps both in float32, and the frameworks round bf16 matmuls
   and elementwise ops at other points: each rounding moves a value by up
   to 2^-8 relative.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.model import Model as JModel
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.engine import pad_cache_to as jpad_cache_to
from repro_torch import configs, interop
from repro_torch.kernels import build
from repro_torch.models.model import Model
from repro_torch.serving import ServeEngine, pad_cache_to

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["granite-3-2b", "chatglm3-6b", "mistral-nemo-12b", "gemma3-27b"]
UNPORTED = [a for a in configs.all_arch_ids() if a not in DENSE]
B = 2
F32_TOL = 1e-5
BF16_TOL = 5e-2


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str = "float32"):
    """(JAX model, its params, port model with the same weights, cfg)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=dtype)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg, device="cpu")
    interop.load_model_params(m, jax.tree.map(np.asarray, params))
    return jm, params, m, cfg


def _tokens(cfg, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, s)).astype(np.int32)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# Configs and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_configs_match_reference(arch):
    assert configs.all_arch_ids() == jconfigs.all_arch_ids()
    for get in ("get_config", "smoke_config"):
        got = getattr(configs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.scan_pattern() == want.scan_pattern()
        assert got.padded_vocab == want.padded_vocab


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-27b"])
def test_weights_round_trip(arch):
    """Reference tree -> port module state -> reference tree: every leaf
    equal, layouts kept, scan leaves unstacked per layer and stacked back."""
    jm, params, m, cfg = _pair(arch)
    tree = jax.tree.map(np.asarray, params)
    back = interop.tree_from_model_state(m.state_dict(), cfg)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    state = m.state_dict()
    assert state["layers.0.attn.wq"].shape == (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)
    assert state["layers.0.attn.wo"].shape == (cfg.n_heads, cfg.resolved_head_dim, cfg.d_model)
    assert len(m.layers) == cfg.n_layers


def test_init_is_seeded():
    cfg = configs.smoke_config("granite-3-2b")
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3)).state_dict()
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3)).state_dict()
    c = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.attn.wq"], c["layers.0.attn.wq"])
    assert torch.count_nonzero(a["layers.0.ln1.scale"]) == 0
    assert a["embed.table"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Prefill, decode and the cache against the JAX model (float32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_and_cache_match_reference(arch):
    """gemma3's prompt (80) is longer than its window (64), so the prefill
    rolls its ring caches and the decode step wraps."""
    jm, params, m, cfg = _pair(arch)
    s = 80 if cfg.sliding_window else 64
    toks = _tokens(cfg, s + 1)
    j_lg, j_cache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :s])})
    t_lg, t_cache = m.prefill({"tokens": torch.from_numpy(toks[:, :s]).long()})
    assert t_lg.shape == (B, cfg.padded_vocab) and t_lg.dtype == torch.float32
    assert _rel(t_lg, j_lg) < F32_TOL
    want_cache = interop.cache_from_tree(jax.tree.map(np.asarray, j_cache), cfg)
    assert sorted(want_cache) == sorted(t_cache)
    for key, want in want_cache.items():
        assert tuple(t_cache[key].shape) == want.shape, key
        assert _rel(t_cache[key], want) < F32_TOL, key

    j_cache = jpad_cache_to(j_cache, jm.abstract_cache(B, s + 8))
    t_cache = pad_cache_to(t_cache, m.cache_shapes(B, s + 8))
    for i, layer in enumerate(m.layers):
        want_slots = 64 if layer.kind == "attn_local" else s + 8
        assert t_cache[f"layers.{i}.k"].shape[1] == want_slots
    j_dec, j_new = jax.jit(jm.decode_step)(
        params, {"tokens": jnp.asarray(toks[:, s:])}, j_cache, jnp.full((B,), s, jnp.int32)
    )
    t_dec, t_new = m.decode_step(
        {"tokens": torch.from_numpy(toks[:, s:]).long()},
        t_cache,
        torch.full((B,), s, dtype=torch.int32),
    )
    assert _rel(t_dec, j_dec) < F32_TOL
    assert np.array_equal(t_dec.numpy().argmax(-1), np.asarray(j_dec).argmax(-1))
    for key, want in interop.cache_from_tree(jax.tree.map(np.asarray, j_new), cfg).items():
        assert _rel(t_new[key], want) < F32_TOL, key


@pytest.mark.parametrize("arch", DENSE)
def test_generate_matches_reference_engine(arch):
    """The shapes of tests/test_archs.py's multi-step decode: a 64-token
    prompt, s_max 96, 4 greedy tokens; float32, tokens equal."""
    jm, params, m, cfg = _pair(arch)
    toks = _tokens(cfg, 64, seed=5)
    want = JEngine(model=jm, params=params, s_max=96).generate(
        {"tokens": jnp.asarray(toks)}, n_steps=4
    )
    got = ServeEngine(model=m, s_max=96).generate({"tokens": torch.from_numpy(toks).long()}, 4)
    assert got.shape == (B, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_bf16_serving_close_to_reference():
    """bf16 compute with float32 weights, as the full config runs."""
    jm, params, m, cfg = _pair("granite-3-2b", "bfloat16")
    s = 64
    toks = _tokens(cfg, s + 1, seed=2)
    j_lg, j_cache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :s])})
    t_lg, t_cache = m.prefill({"tokens": torch.from_numpy(toks[:, :s]).long()})
    assert t_lg.dtype == torch.bfloat16
    assert _rel(t_lg, j_lg) < BF16_TOL
    j_cache = jpad_cache_to(j_cache, jm.abstract_cache(B, s + 8))
    t_cache = pad_cache_to(t_cache, m.cache_shapes(B, s + 8))
    j_dec, _ = jax.jit(jm.decode_step)(
        params, {"tokens": jnp.asarray(toks[:, s:])}, j_cache, jnp.full((B,), s, jnp.int32)
    )
    t_dec, _ = m.decode_step(
        {"tokens": torch.from_numpy(toks[:, s:]).long()}, t_cache,
        torch.full((B,), s, dtype=torch.int32),
    )
    assert _rel(t_dec, j_dec) < BF16_TOL


@pytest.mark.parametrize("arch", DENSE)
def test_port_prefill_decode_consistency(arch):
    """tests/test_archs.py's invariant on the port: decode(prefill(s - 1),
    token s) == prefill(s) last logits, float32, relative error < 5e-4."""
    _, _, m, cfg = _pair(arch)
    s_total = 65
    toks = torch.from_numpy(_tokens(cfg, s_total)).long()
    lg_full, _ = m.prefill({"tokens": toks})
    _, cache = m.prefill({"tokens": toks[:, : s_total - 1]})
    cache = pad_cache_to(cache, m.cache_shapes(B, s_total + 8))
    lengths = torch.full((B,), s_total - 1, dtype=torch.int32)
    lg_dec, _ = m.decode_step({"tokens": toks[:, s_total - 1 :]}, cache, lengths)
    err = float((lg_full - lg_dec).abs().max() / (lg_full.abs().max() + 1e-9))
    assert err < 5e-4, f"{arch}: prefill/decode mismatch relerr={err:.2e}"


# ---------------------------------------------------------------------------
# Engine and launcher
# ---------------------------------------------------------------------------


def test_engine_counts_no_launch_on_cpu_and_refuses_past_s_max():
    _, _, m, cfg = _pair("granite-3-2b")
    eng = ServeEngine(model=m, s_max=70)
    toks = torch.from_numpy(_tokens(cfg, 64)).long()
    build.reset_launches()
    out = eng.generate({"tokens": toks}, n_steps=7)
    assert out.shape == (B, 7) and out.dtype == torch.int64
    assert all(n == 0 for n in build.launches.values())
    with pytest.raises(ValueError, match="s_max"):
        eng.generate({"tokens": toks}, n_steps=8)
    with pytest.raises(ValueError, match="s_max"):
        ServeEngine(model=m, s_max=32).prefill({"tokens": toks})


def test_train_mode_hidden_matches_reference():
    """The forward without a cache (``Model.hidden(mode="train")``)."""
    jm, params, m, cfg = _pair("gemma3-27b")
    toks = _tokens(cfg, 96, seed=9)
    want, _ = jax.jit(lambda p, b: jm.hidden(p, b, mode="train"))(
        params, {"tokens": jnp.asarray(toks)}
    )
    got, cache = m.hidden({"tokens": torch.from_numpy(toks).long()}, mode="train")
    assert cache is None and got.shape == (B, 96, cfg.d_model)
    assert _rel(got, want) < F32_TOL


def test_pad_cache_to_int_and_shapes():
    cache = {"layers.0.k": torch.ones(2, 5, 1, 4), "layers.0.v": torch.ones(2, 5, 1, 4)}
    out = pad_cache_to(cache, 8)
    assert out["layers.0.k"].shape == (2, 8, 1, 4)
    assert torch.count_nonzero(out["layers.0.v"][:, 5:]) == 0
    out = pad_cache_to(cache, {"layers.0.k": (2, 5, 1, 4), "layers.0.v": (2, 6, 1, 4)})
    assert out["layers.0.k"] is cache["layers.0.k"] and out["layers.0.v"].shape[1] == 6
    _, _, m, cfg = _pair("gemma3-27b")
    zeros = m.init_cache(B, 96)
    assert {k: tuple(v.shape) for k, v in zeros.items()} == m.cache_shapes(B, 96)
    assert all(v.dtype == torch.float32 and not v.any() for v in zeros.values())
    assert zeros["layers.0.k"].shape[1] == 64 and zeros["layers.5.k"].shape[1] == 96


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "gemma3-27b", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "70", "--gen", "5", "--s-max", "80"])
    assert out.shape == (2, 5)
    assert "gemma3-27b on cpu: generated 2x5 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model(configs.smoke_config(arch), device="cpu")


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(configs.smoke_config("granite-3-2b"))


def test_serving_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.serving, repro_torch.launch.serve, repro_torch.configs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DENSE)
def test_generate_on_card_matches_reference_engine(cuda, arch):
    """float32 on the card: the kernels' tokens equal the JAX engine's."""
    jm, params, m_cpu, cfg = _pair(arch)
    m = Model(cfg, device=cuda)
    m.load_state_dict(m_cpu.state_dict())
    toks = _tokens(cfg, 64, seed=5)
    want = JEngine(model=jm, params=params, s_max=96).generate(
        {"tokens": jnp.asarray(toks)}, n_steps=4
    )
    build.reset_launches()
    got = ServeEngine(model=m, s_max=96).generate(
        {"tokens": torch.from_numpy(toks).long().to(cuda)}, 4
    )
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert build.launches["rmsnorm"] == 4 * (2 * n + 1)
    assert build.launches["flash_attention"] == n
    assert build.launches["decode_attention"] == 3 * n
    assert np.array_equal(got.cpu().numpy(), np.asarray(want))
