"""Kernel B3 (select_pivots) on the CPU: the plain PyTorch selection against
the reference's jnp loop and its Pallas kernel in interpret mode, the
candidate order, the block permutation, and the wrapper's routing.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py).  Pivot orders are compared exactly: on these tiles every
step's maximum is separated from the runner-up by far more than float32
rounding, and exact ties (zero and duplicate columns, -1 fill) go to the
lowest index in every version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops import pallas_select
from cuda_qr_tpu.ops import qrcp as rq
from cuda_qr_tpu_torch.ops import qrcp as pq
from cuda_qr_tpu_torch.ops.select_kernel import (in_kernel_range, select_pivots_kernel,
                                                 select_pivots_plain, selection_margin,
                                                 supported)

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

_H = jax.lax.Precision.HIGHEST


def tile(rng, kind, l=64, cand=128):
    S = rng.standard_normal((l, cand)).astype(np.float32)
    if kind == "zero":
        S[:, [3, 40, 41, 99]] = 0.0
    elif kind == "duplicate":
        S[:, 50] = S[:, 7]
        S[:, 90] = S[:, 7]
        S[:, 11] = S[:, 12]
    norms = (S.astype(np.float64) ** 2).sum(0).astype(np.float32)
    if kind == "inactive":
        norms[::3] = -1.0
    return S, norms


@pytest.mark.parametrize("kind", ["gaussian", "zero", "duplicate", "inactive"])
def test_plain_matches_pallas_interpret(rng, kind):
    S, norms = tile(rng, kind)
    nb = 32
    want = np.asarray(pallas_select.select_pivots_pallas(
        jnp.asarray(S), jnp.asarray(norms), nb, interpret=True))
    got = select_pivots_plain(torch.from_numpy(S), torch.from_numpy(norms), nb).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got[got >= 0].tolist()) == list(range(nb))
    if kind == "inactive":
        assert (got[::3] == -1).all()


@pytest.mark.parametrize("kind,j0,nb,cand", [
    ("gaussian", 0, 32, 128),
    ("zero", 0, 32, 128),
    ("duplicate", 0, 16, 64),
    ("gaussian", 160, 32, 128),    # candidates from the top 128 of 96 actives + -1 fill
    ("zero", 192, 16, 128),        # 64 actives, half the candidates are -1 fill
])
def test_select_pivots_matches_reference_loop(rng, kind, j0, nb, cand):
    S, _ = tile(rng, kind, l=48, cand=256)
    want = np.asarray(rq._select_pivots(jnp.asarray(S), jnp.int32(j0), nb, cand, _H))
    got = pq._select_pivots(torch.from_numpy(S), j0, nb, cand).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:j0] == -1).all()


def test_candidates_break_ties_like_top_k():
    norms = np.array([0.0, 2.0, -1.0, 2.0, 0.0, 5.0, -1.0, 2.0, 0.0, 0.0, 5.0, -1.0],
                     np.float32)
    for cand in (3, 6, 9, 12):
        _, want = jax.lax.top_k(jnp.asarray(norms), cand)
        got = pq._candidates(torch.from_numpy(norms), cand)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("j0,nb,n_pad", [(0, 16, 64), (32, 16, 96), (64, 32, 128)])
def test_block_perm_matches_reference(rng, j0, nb, n_pad):
    ordsel = np.full(n_pad, -1, np.int32)
    chosen = rng.choice(np.arange(j0, n_pad), nb, replace=False)
    ordsel[chosen] = rng.permutation(nb)
    want = np.asarray(rq._block_perm(jnp.asarray(ordsel), jnp.int32(j0), nb))
    got = pq._block_perm(torch.from_numpy(ordsel), j0, nb).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n_pad))
    np.testing.assert_array_equal(got[j0:j0 + nb], chosen[np.argsort(ordsel[chosen])])


@pytest.mark.parametrize("l,cand,nb,dtype", [
    (160, 512, 128, np.float32), (64, 128, 32, np.float32), (288, 1024, 256, np.float32),
    (160, 500, 128, np.float32), (161, 512, 128, np.float32), (48, 128, 300, np.float32),
    (2048, 1024, 128, np.float32), (160, 512, 128, np.float64)])
def test_supported_mirrors_reference_gate(l, cand, nb, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert supported(l, cand, nb, tdt) == pallas_select.supported(l, cand, nb, jnp.dtype(dtype))


def test_cpu_wrapper_takes_plain_leaves_input_and_counts_nothing(rng):
    S, norms = tile(rng, "gaussian")
    St, nt = torch.from_numpy(S.copy()), torch.from_numpy(norms.copy())
    before = select_pivots_kernel.launches
    got = select_pivots_kernel(St, nt, 32)
    assert select_pivots_kernel.launches == before
    assert torch.equal(got, select_pivots_plain(St, nt, 32))
    assert got.dtype == torch.int32
    assert np.array_equal(St.numpy(), S) and np.array_equal(nt.numpy(), norms)


def test_selection_margin():
    """The float64 margin the card checks use: exact ties do not count,
    near-ties do."""
    S = torch.diag(torch.tensor([1.0, 1.0, 0.5, 1.0 + 1e-9], dtype=torch.float64))
    S[:, 1] = S[:, 0]                       # an exact duplicate of column 0
    norms = (S * S).sum(0)
    assert 0 < selection_margin(S, norms, 1) < 1e-8      # 1 + 1e-9 vs 1
    assert selection_margin(S[:, :3], norms[:3], 2) == pytest.approx(0.75)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel or raises."""
    with pytest.raises(ValueError, match="unsupported device"):
        select_pivots_kernel(torch.empty((8, 128), device="meta"),
                             torch.empty(128, device="meta"), 4)


@pytest.mark.parametrize("nb", [32, 64, 128, 256])
def test_every_qrcp_tile_is_in_the_kernels_range(nb):
    """QRCP's tiles (l = nb + 32, cand = 4 nb) pass the gate and the
    kernel takes each of them."""
    l, cand = pq.sketch_rows(1 << 20, nb), 4 * nb
    assert l == nb + 32 and supported(l, cand, nb, torch.float32)
    assert in_kernel_range(l, cand)


@pytest.mark.parametrize("l,cand,want", [
    (1024, 1024, False),        # the gate admits it (4 MiB); QRCP never makes it
    (296, 512, False),          # more rows than nb + 32 at nb = 256
    (160, 96, False),           # 12 columns a CTA: not a multiple of 8
    (8, 64, True),              # 8 columns a CTA, one padded row block
])
def test_kernel_range_by_shape(l, cand, want):
    assert in_kernel_range(l, cand) == want
