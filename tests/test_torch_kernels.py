"""The port's (max,+) DP stage against the JAX package, bit for bit.

The plain PyTorch version (``repro_torch.kernels.ref``) and the wrappers'
CPU route are held against ``repro.kernels.ref.maxplus_conv`` and against
the Pallas kernels run in interpret mode, on the same numpy inputs.  The
stage only adds and compares in float32, so the tolerance is zero: every
output is compared as raw bits.  ``gpu``-marked tests build the CUDA kernel
and hold it against the plain version on the card; they skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mckp_dp, ops, ref

NBS = [1, 7, 256, 300, 1000]

# the shapes here are tiny: one intra-op thread keeps this file from
# crowding the other test workers' cores
torch.set_num_threads(1)


def _inputs(rows: int, nb: int, seed: int):
    """dp, f [rows, nb] float32 on a 1/8 lattice (many exact ties, so the
    smallest-argmax rule is exercised) with some -inf curve entries."""
    rng = np.random.default_rng(seed)
    dp = (np.round(rng.uniform(0, 4, (rows, nb)) * 8) / 8).astype(np.float32)
    f = (np.round(rng.uniform(0, 4, (rows, nb)) * 8) / 8).astype(np.float32)
    f[rng.random((rows, nb)) < 0.1] = -np.inf
    f[:, 0] = 0.0
    return dp, f


def _assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("nb", NBS)
def test_plain_conv_matches_reference(nb):
    dp, f = _inputs(1, nb, seed=nb)
    out, arg = ref.maxplus_conv(torch.from_numpy(dp[0]), torch.from_numpy(f[0]))
    w_out, w_arg = jref.maxplus_conv(jnp.asarray(dp[0]), jnp.asarray(f[0]))
    _assert_bits(out.numpy(), w_out)
    _assert_bits(arg.numpy(), w_arg)


@pytest.mark.parametrize("nb", NBS)
def test_conv_matches_pallas_interpret(nb):
    dp, f = _inputs(1, nb, seed=nb + 1)
    out, arg = ops.maxplus_conv(torch.from_numpy(dp[0]), torch.from_numpy(f[0]))
    w_out, w_arg = jops.maxplus_conv(jnp.asarray(dp[0]), jnp.asarray(f[0]))
    _assert_bits(out.numpy(), w_out)
    _assert_bits(arg.numpy(), w_arg)


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("nb", NBS)
def test_batched_conv_matches_reference_and_pallas(rows, nb):
    dp, f = _inputs(rows, nb, seed=10 * nb + rows)
    out, arg = ops.maxplus_conv_batched(torch.from_numpy(dp), torch.from_numpy(f))
    w_out, w_arg = jops.maxplus_conv_batched(jnp.asarray(dp), jnp.asarray(f))
    _assert_bits(out.numpy(), w_out)
    _assert_bits(arg.numpy(), w_arg)
    for r in range(rows):
        r_out, r_arg = jref.maxplus_conv(jnp.asarray(dp[r]), jnp.asarray(f[r]))
        _assert_bits(out[r].numpy(), r_out)
        _assert_bits(arg[r].numpy(), r_arg)


def test_scans_match_pallas_interpret():
    rng = np.random.default_rng(7)
    leaves, classes, stages, nb = 3, 4, 6, 300
    f_groups = np.maximum.accumulate(
        rng.uniform(0, 1, (leaves, classes, nb)), axis=2
    ).astype(np.float32)
    f_groups[..., 0] = 0.0
    gids = rng.integers(0, classes, (leaves, stages)).astype(np.int32)

    dp, args = ops.maxplus_scan_batched(
        torch.from_numpy(f_groups), torch.from_numpy(gids).long()
    )
    w_dp, w_args = jops.maxplus_scan_batched(jnp.asarray(f_groups), gids)
    _assert_bits(dp.numpy(), w_dp)
    _assert_bits(args.numpy(), w_args)

    dp1, args1 = ops.maxplus_scan(
        torch.from_numpy(f_groups[0]), torch.from_numpy(gids[0]).long()
    )
    w_dp1, w_args1 = jops.maxplus_scan(jnp.asarray(f_groups[0]), gids[0])
    _assert_bits(dp1.numpy(), w_dp1)
    _assert_bits(args1.numpy(), w_args1)


def test_cpu_route_takes_plain_version_without_launching():
    mckp_dp.reset_launches()
    dp, f = _inputs(2, 64, seed=3)
    out, arg = ops.maxplus_conv_batched(torch.from_numpy(dp), torch.from_numpy(f))
    want_out, want_arg = ref.maxplus_conv_batched(
        torch.from_numpy(dp), torch.from_numpy(f)
    )
    _assert_bits(out.numpy(), want_out.numpy())
    _assert_bits(arg.numpy(), want_arg.numpy())
    assert mckp_dp.launches == {
        "maxplus_conv": 0, "maxplus_conv_batched": 0, "maxplus_stage_batched": 0,
        "rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
    }


def test_kernel_wrapper_refuses_cpu_tensors():
    dp, f = _inputs(1, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        mckp_dp.maxplus_conv_batched(torch.from_numpy(dp), torch.from_numpy(f))
    with pytest.raises(ValueError, match="equal-shape"):
        ops.maxplus_conv_batched(torch.zeros(2, 3), torch.zeros(2, 4))


def test_kernel_source_names_the_replaced_tpu_kernels():
    src = mckp_dp.SOURCES["maxplus_conv"].read_text()
    assert "maxplus_conv_pallas_batched" in src and "maxplus_conv_pallas" in src
    assert "--use_fast_math" not in " ".join(mckp_dp.NVCC_FLAGS)
    assert mckp_dp.library_path("maxplus_conv").parent == mckp_dp.BUILD_DIR


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows, nb", [(1, 1), (1, 7), (1, 11288), (8, 1000), (3, 300), (2, 129)]
)
def test_kernel_matches_plain_on_card(cuda, rows, nb):
    dp, f = _inputs(rows, nb, seed=rows * nb)
    dp_t = torch.from_numpy(dp).to(cuda)
    f_t = torch.from_numpy(f).to(cuda)
    mckp_dp.reset_launches()
    out, arg = mckp_dp.maxplus_conv_batched(dp_t, f_t)
    torch.cuda.synchronize()
    assert mckp_dp.launches["maxplus_conv_batched"] == 1
    want_out, want_arg = ref.maxplus_conv_batched(dp_t, f_t)
    _assert_bits(out.cpu().numpy(), want_out.cpu().numpy())
    _assert_bits(arg.cpu().numpy(), want_arg.cpu().numpy())
    for r in range(rows):
        s_out, s_arg = ops.maxplus_conv(dp_t[r], f_t[r])
        _assert_bits(s_out.cpu().numpy(), out[r].cpu().numpy())
        _assert_bits(s_arg.cpu().numpy(), arg[r].cpu().numpy())
    assert mckp_dp.launches["maxplus_conv"] == rows


@pytest.mark.gpu
def test_kernel_refuses_float64_on_card(cuda):
    x = torch.zeros(1, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        mckp_dp.maxplus_conv_batched(x, x)


def test_jax_stays_on_cpu_with_x64_off():
    assert jax.default_backend() == "cpu"
    assert not jax.config.jax_enable_x64
