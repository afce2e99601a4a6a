"""Port's sandwich forward as its three kernels' plain stages (F1
``fwd_expand``, F2 ``fwd_taps``, F3 ``fwd_tapsum``; chip_smoke.py holds the
CUDA kernels against them on the card), composed on CPU tensors, against
the JAX TPU kernel ``_pallas_sandwich`` run interpreted; F3's shifted
windows against ``F.conv2d`` at the image edge; F1's r against K1's; the
wrappers' CPU and other-device paths and the per-stage work counts.

Bars: float32 1e-5 (as tests/test_torch_sandwich.py holds the plain
version; both sum in float32, in other orders).  bfloat16 1e-2: both sides
round r to bf16 once and y once, and another summation order of z moves a
rounding of r by one bf16 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import rel_l2
from md_rdm_tpu.kernels.dense_sandwich import _pallas_sandwich
from md_rdm_tpu_torch.core import trace
from md_rdm_tpu_torch.kernels import dense_sandwich as ds


def _inputs(b, s, c_in, seed=0):
    """JAX layouts (HWIO), as tests/test_dense_sandwich.py builds them."""
    rng = np.random.default_rng(seed)
    c_mid = 48 * s
    xr = rng.standard_normal((b, s, s, c_in)).clip(0).astype(np.float32)
    w1 = (rng.standard_normal((1, 1, c_in, c_mid)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c_mid, 48)) * 0.05).astype(np.float32)
    scale = (rng.standard_normal(c_mid) * 0.1 + 1.0).astype(np.float32)
    shift = (rng.standard_normal(c_mid) * 0.1).astype(np.float32)
    return xr, w1, scale, shift, w2


def _port(xr, w1, scale, shift, w2, dtype=torch.float32):
    """JAX layouts -> the port's: x NHWC in ``dtype``, conv weights OIHW."""
    return (torch.from_numpy(xr).to(dtype),
            torch.from_numpy(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))),
            torch.from_numpy(scale), torch.from_numpy(shift),
            torch.from_numpy(np.ascontiguousarray(w2.transpose(3, 2, 0, 1))))


def _stages(x, w1, scale, shift, w2):
    """F1 -> F2 -> F3 through the wrappers, as ``_forward`` runs them on
    the card."""
    b, s = x.shape[:2]
    r = ds.fwd_expand(x, w1, scale, shift)
    taps = ds.fwd_taps(r, w2)
    return ds.fwd_tapsum(taps.view(b, s, s, ds.GK), x.dtype)


def _launches(fns=ds.FWD_KERNELS):
    """Launch counters of ``fns`` (``kernel.<name>.launches``)."""
    counters = trace.snapshot()["counters"]
    return [counters.get(f"kernel.{fn.__name__}.launches", 0) for fn in fns]


@pytest.mark.parametrize("b,s,c_in", [(2, 15, 96), (2, 29, 192),
                                      (1, 57, 336), (1, 15, 2064)])
def test_stages_compose_to_jax_kernel(b, s, c_in):
    args = _inputs(b, s, c_in, seed=s + c_in)
    want = np.asarray(_pallas_sandwich(*[jnp.asarray(a) for a in args],
                                       interpret=True))
    before = _launches()
    got = _stages(*_port(*args))
    assert _launches() == before   # CPU: no launch
    assert got.shape == (b, s, s, 48) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("b,s,c_in", [(2, 15, 96), (1, 29, 240),
                                      (1, 57, 144)])
def test_stages_compose_to_jax_kernel_bf16(b, s, c_in):
    """The TPU kernel interpreted on bf16 x has the stages' dtype
    semantics (z summed in float32, r and y rounded once)."""
    args = _inputs(b, s, c_in, seed=3 + s)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    want = np.asarray(_pallas_sandwich(*jargs, interpret=True)
                      .astype(jnp.float32))
    got = _stages(*_port(*args, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel_l2(got.float().numpy(), want) < 1e-2


@pytest.mark.parametrize("s", [1, 9, 15])
def test_tapsum_matches_conv2d_at_image_edge(s):
    """F2 then F3 is the 3x3 conv with zero padding: every tap's window
    crosses the border of an odd-sized image (S = 1: only the centre tap
    sees a pixel).  The weights differ under every flip of ky and kx, so a
    shift in the wrong direction fails."""
    rng = np.random.default_rng(20 + s)
    b, c_mid = 2, 40
    r = torch.from_numpy(rng.standard_normal((b, s, s, c_mid))
                         .astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((48, c_mid, 3, 3))
                          .astype(np.float32))
    w2 = w2 + torch.arange(9.0).reshape(3, 3)   # asymmetric in ky and kx
    assert not torch.equal(w2, w2.flip(2)) and not torch.equal(w2,
                                                               w2.flip(3))
    taps = ds.fwd_taps_reference(r.reshape(-1, c_mid), w2)
    got = ds.fwd_tapsum_reference(taps.view(b, s, s, ds.GK), torch.float32)
    want = F.conv2d(r.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert rel_l2(got.numpy(), want.numpy()) < 1e-5
    flipped = F.conv2d(r.permute(0, 3, 1, 2), w2.flip(2, 3),
                       padding=1).permute(0, 2, 3, 1)
    if s > 1:
        assert rel_l2(got.numpy(), flipped.numpy()) > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expand_r_equals_bwd_recompute_r(dtype):
    """F1's r and K1's r come from one formula: equal bit for bit."""
    args = list(_port(*_inputs(2, 9, 96, seed=30)))
    args[0] = args[0].to(dtype)
    rng = np.random.default_rng(31)
    g = torch.from_numpy(rng.standard_normal((2, 9, 9, 48))
                         .astype(np.float32)).to(dtype)
    r = ds.fwd_expand_reference(*args[:4])
    r_k1 = ds.bwd_recompute_reference(*args, g)[0]
    assert r.dtype == dtype and r.shape == (2 * 9 * 9, 9 * 48)
    assert torch.equal(r, r_k1)
    assert bool((r >= 0).all()) and bool((r > 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_wrappers_run_plain_stages_on_cpu(dtype):
    """Each wrapper on CPU tensors returns its plain stage's result in the
    stated dtypes and layouts and launches nothing; dense_sandwich's CPU
    path (the plain stages composed) counts no launch either."""
    args = list(_port(*_inputs(2, 9, 96, seed=12)))
    args[0] = args[0].to(dtype)
    x, w1, scale, shift, w2 = args
    before = _launches(ds.FWD_KERNELS + (ds.dense_sandwich,))
    r = ds.fwd_expand(x, w1, scale, shift)
    assert torch.equal(r, ds.fwd_expand_reference(x, w1, scale, shift))
    assert r.dtype == dtype and r.shape == (2 * 81, 9 * 48)
    packed = ds.pack_weights(w1, scale, shift, w2, dtype)
    taps = ds.fwd_taps(r, w2, packed.w2n)
    assert torch.equal(taps, ds.fwd_taps_reference(r, w2))
    assert taps.dtype == torch.float32 and taps.shape == (2 * 81, ds.GK)
    taps = taps.view(2, 9, 9, ds.GK)
    y = ds.fwd_tapsum(taps, dtype)
    assert torch.equal(y, ds.fwd_tapsum_reference(taps, dtype))
    assert y.dtype == dtype and y.shape == (2, 9, 9, 48)
    ds.dense_sandwich_packed(x, packed)
    assert _launches(ds.FWD_KERNELS + (ds.dense_sandwich,)) == before
    # in float32 the stages and the plain sandwich are one function
    if dtype == torch.float32:
        want = ds.dense_sandwich_reference(*args)
        assert rel_l2(y.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("stage", ["fwd_expand", "fwd_taps", "fwd_tapsum"])
def test_stage_wrappers_reject_other_devices(stage):
    x, w1, scale, shift, w2 = (t.to("meta") for t in _port(*_inputs(1, 9,
                                                                    96)))
    call = {"fwd_expand": lambda: ds.fwd_expand(x, w1, scale, shift),
            "fwd_taps": lambda: ds.fwd_taps(
                torch.empty((81, 9 * 48), device="meta"), w2),
            "fwd_tapsum": lambda: ds.fwd_tapsum(
                torch.empty((1, 9, 9, ds.GK), device="meta"),
                torch.float32)}[stage]
    with pytest.raises(ValueError, match="device"):
        call()


@pytest.mark.parametrize("s,c_in", [(57, 96), (57, 336), (15, 2064)])
def test_fwd_stage_work_adds_up(s, c_in):
    """F1's and F2's multiply-adds add up to the sandwich's; F3's additions
    are one fewer than each output's in-image taps, counted here by brute
    force; each stage's bytes count its own inputs and outputs."""
    b, c_mid = 16, 48 * s
    work = ds.fwd_stage_work(b, s, c_in, c_mid, 2)
    assert list(work) == [fn.__name__ for fn in ds.FWD_KERNELS]
    assert work["fwd_expand"][0] + work["fwd_taps"][0] == ds.sandwich_flops(
        b, s, c_in, c_mid)
    inside = sum(0 <= i + ky - 1 < s and 0 <= j + kx - 1 < s
                 for i in range(s) for j in range(s)
                 for ky in range(3) for kx in range(3))
    assert work["fwd_tapsum"][0] == b * 48 * (inside - s * s)
    pix = b * s * s
    assert work["fwd_taps"][1] == (2 * (pix * c_mid + c_mid * 432)
                                   + 4 * pix * 432)
    assert work["fwd_tapsum"][1] == 4 * pix * 432 + 2 * pix * 48
    # F1 writes r: P * C_mid elements in the compute dtype
    assert work["fwd_expand"][1] > 2 * pix * c_mid


# ---- the split of K across a thread-block cluster (F1, F2) ------------------
# Clusters of s blocks of F1 and F2 that an H100 80GB HBM3 (132 SMs) holds
# at once (cudaOccupancyMaxActiveClusters, the same for both kernels and
# dtypes; chip_smoke.py --split-only prints them).
H100_CLUSTERS = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}
H100_SMS = 132
LIVE_BLOCKS = {57: (6, 96), 29: (12, 192), 15: (36, 384)}


def _live_products(batch, s, kernel):
    """(p, n, k) of F1's or F2's product at every layer of the live
    encoder's dense block at size ``s``."""
    n_layers, c0 = LIVE_BLOCKS[s]
    p, c_mid = batch * s * s, 48 * s
    return [(p, c_mid, c0 + 48 * i) if kernel == "fwd_expand"
            else (p, ds.GK, c_mid) for i in range(n_layers)]


def _clusters(s):
    return H100_CLUSTERS.get(s, 0)


# (batch, S, kernel) where the float32 rule must split K on every layer of
# the block, and where it must never.
SPLIT = {(1, 15, "fwd_expand"), (1, 15, "fwd_taps"), (16, 15, "fwd_expand"),
         (1, 29, "fwd_taps")}
UNSPLIT = {(16, 57, "fwd_expand")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fwd_expand", "fwd_taps"])
@pytest.mark.parametrize("batch,s", [(b, s) for b in (1, 16)
                                     for s in (57, 29, 15)])
def test_split_rule_on_live_shapes(batch, s, kernel, dtype):
    """The rule's blocks a tile at each live layer: whole slices of at
    least MIN_SLICE_K k tiles, at most MAX_CLUSTER (8, portable), never a
    modelled time above s = 1's; S=57 F1 at batch 16 unsplit; F1 at S=15
    and F2 at S=29 and S=15 at batch 1, and F1 at S=15 at batch 16,
    split (float32, the cells' dtype)."""
    chosen = []
    for p, n, k in _live_products(batch, s, kernel):
        tiles, k_tiles = ds.product_tiles(p, n, k, dtype)
        m = ds.fwd_splits(p, n, k, dtype, _clusters, H100_SMS)
        assert 1 <= m <= ds.MAX_CLUSTER == 8
        assert m == 1 or k_tiles // m >= ds.MIN_SLICE_K
        assert (ds.split_time(tiles, k_tiles, m, _clusters(m), H100_SMS,
                              dtype)
                <= ds.split_time(tiles, k_tiles, 1, _clusters(1), H100_SMS,
                                 dtype))
        chosen.append(m)
    if dtype == torch.float32 and (batch, s, kernel) in SPLIT:
        assert min(chosen) > 1, chosen
    if (batch, s, kernel) in UNSPLIT:
        assert set(chosen) == {1}


def test_split_time_counts_waves_and_lone_blocks():
    """S=15 F2 at batch 1 in float32: 8 tiles of 45 k tiles.  Unsplit, one
    wave of 8 blocks, each alone on its SM; at s = 8, 64 blocks in one
    wave, each a slice of 6 k tiles and the reduction's cost; at batch 16
    (116 tiles) s = 2 puts 232 blocks on 132 SMs: paired."""
    f32 = torch.float32
    alone, cost = ds.ALONE[f32], ds.SPLIT_COST[f32]
    assert ds.split_time(8, 45, 1, 264, 132, f32) == pytest.approx(45 * alone)
    assert ds.split_time(8, 45, 8, 30, 132, f32) == pytest.approx(
        (6 + cost) * alone)
    assert ds.split_time(116, 45, 2, 132, 132, f32) == pytest.approx(23 + cost)
    # 1628 tiles at s = 1: six full waves of 264 and a last of 44 blocks
    assert ds.split_time(1628, 171, 1, 264, 132, f32) == pytest.approx(
        6 * 171 + 171 * alone)


def test_k_splits_prefers_the_smaller_on_a_near_tie():
    """Where two splits model within SPLIT_TIE of each other, the smaller
    is taken; a product with fewer than 2 * MIN_SLICE_K k tiles stays
    whole."""
    f32 = torch.float32
    times = {s: ds.split_time(8, 45, s, _clusters(s), H100_SMS, f32)
             for s in range(1, 9)}
    got = ds.k_splits(8, 45, _clusters, H100_SMS, f32)
    best = min(times.values())
    assert times[got] <= best * (1 + ds.SPLIT_TIE)
    assert all(t > best * (1 + ds.SPLIT_TIE) for s, t in times.items()
               if s < got)
    assert ds.k_splits(12, 2 * ds.MIN_SLICE_K - 1, _clusters, H100_SMS,
                       f32) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_count_no_split(dtype):
    """On CPU tensors F1 and F2 run their plain stages: no launch, and no
    ``kernel.fwd_*.split`` counter appears."""
    x, w1, scale, shift, w2 = _port(*_inputs(1, 15, 96, seed=4))
    x = x.to(dtype)
    before = _launches(ds.SPLIT_KERNELS)
    r = ds.fwd_expand(x, w1, scale, shift)
    ds.fwd_taps(r, w2)
    assert not any(k.endswith(".split")
                   for k in trace.snapshot()["counters"])
    assert _launches(ds.SPLIT_KERNELS) == before
