"""``ModelConfig.flat_block`` in the port: the dense block as one in-place
NHWC buffer (``models/densenet.py::DenseBlock``'s flat form), on the CPU.

F3's plain stage writing into a slot of a block's buffer and K1's and K4's
plain stages reading the cotangent from such a slot equal their contiguous
selves bit for bit; the flat block against the port's plain block in eval
and train (outputs, running statistics, every gradient); against the JAX
``DenseBlock(fused="off")`` with and without ``remat`` and against the
JAX ``DenseBlockFlat(interpret=True)`` (its TPU kernels interpreted, eval
forward and train statistics); and the routing: ``Routing.flat_block``
and ``flat`` per mode, the block's own choice on its input, and the
config and CLI reaching the encoder.  Blocks: ``tests/_torch_blocks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_blocks as tb
from _torch_blocks import two_threads  # noqa: F401 (autouse fixture)
from _torch_parity import rel_l2, torch_to_nhwc
from md_rdm_tpu.kernels import dense_sandwich as jds
from md_rdm_tpu.models import densenet as jdn
from md_rdm_tpu_torch.cli import train as cli_train
from md_rdm_tpu_torch.core.config import ModelConfig
from md_rdm_tpu_torch.kernels import dense_sandwich as ds
from md_rdm_tpu_torch.models import densenet as tdn
from md_rdm_tpu_torch.models import routing as rt
from md_rdm_tpu_torch.models.rdm import DepthEstimationNet
from md_rdm_tpu_torch.models.routing import Routing

DTYPES = pytest.mark.parametrize("dtype", tb.DTYPES, ids=["f32", "bf16"])


def _flat_block(fused="on_all_bwd", flat="on_all", **kw):
    return tdn.DenseBlock(tb.LAYERS, tb.C0, tb.BN,
                          routing=Routing(fused, flat), **kw)


def _plain_block(**kw):
    return _flat_block(flat="off", **kw)


# ---- the strided plain stages -----------------------------------------------

def _slot(dtype, c_final=240, c_at=144, seed=0):
    """A seeded [B, S, S, c_final] buffer and its 48-channel slot at
    ``c_at``."""
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn(2, 15, 15, c_final, generator=g).to(dtype)
    return buf, buf[..., c_at:c_at + 48]


@DTYPES
def test_row_stride_of_slots_and_other_layouts(dtype):
    buf, slot = _slot(dtype)
    assert ds.row_stride(slot) == 240
    assert ds.row_stride(slot.contiguous()) == 48
    assert ds.row_stride(buf[..., 1:49]) == 240      # unaligned start
    assert ds.row_stride(buf[:, :, :, :48].permute(0, 2, 1, 3)) is None
    assert ds.row_stride(torch.zeros(2, 15, 15, 50)[..., :48]) is None
    assert ds.row_stride(buf[..., :96]) is None


@DTYPES
def test_tapsum_into_a_slot_equals_the_contiguous_stage(dtype):
    """F3's plain stage (and its wrapper on the CPU) writing y into the
    slot: y equal to the contiguous y bit for bit, every other channel
    untouched; a slot of another layout is refused."""
    g = torch.Generator().manual_seed(1)
    taps = torch.randn(2, 15, 15, ds.GK, generator=g)
    want = ds.fwd_tapsum_reference(taps, dtype)
    for fn in (ds.fwd_tapsum_reference, ds.fwd_tapsum):
        buf, slot = _slot(dtype)
        before = buf.clone()
        got = fn(taps, dtype, slot)
        assert got.data_ptr() == slot.data_ptr()
        assert torch.equal(buf[..., 144:192], want)
        assert torch.equal(buf[..., :144], before[..., :144])
        assert torch.equal(buf[..., 192:], before[..., 192:])
    bad = torch.zeros(2, 15, 15, 50, dtype=dtype)[..., 1:49]
    with pytest.raises(ValueError, match="multiple of 48"):
        ds.fwd_tapsum(taps, dtype, bad)
    with pytest.raises(ValueError):
        ds.fwd_tapsum(taps, dtype, _slot(torch.float32 if dtype
                                         == torch.bfloat16
                                         else torch.bfloat16)[1])


def _sandwich_args(dtype):
    g = torch.Generator().manual_seed(3)
    return (torch.randn(2, 15, 15, 96, generator=g).clamp_min(0).to(dtype),
            torch.randn(96, 96, 1, 1, generator=g) * 0.1,
            torch.randn(96, generator=g) * 0.1 + 1,
            torch.randn(96, generator=g) * 0.1,
            torch.randn(48, 96, 3, 3, generator=g) * 0.05)


@DTYPES
def test_recompute_and_dw2_read_a_slot_as_the_contiguous_cotangent(dtype):
    """K1's and K4's plain stages (and the composed backward) given the
    cotangent as a slot of a block's cotangent equal their results on the
    contiguous copy bit for bit."""
    args = _sandwich_args(dtype)
    _, g = _slot(dtype, seed=2)
    gc = g.contiguous()
    for a, b in zip(ds.bwd_recompute(*args, g), ds.bwd_recompute(*args, gc)):
        assert torch.equal(a, b)
    r = ds.bwd_recompute(*args, gc)[0]
    assert torch.equal(ds.bwd_dw2(r, g), ds.bwd_dw2(r, gc))
    for a, b in zip(ds.dense_sandwich_bwd(*args, g),
                    ds.dense_sandwich_bwd(*args, gc)):
        assert torch.equal(a, b)


@DTYPES
def test_forward_into_a_slot_equals_the_sandwich(dtype):
    """The sandwich's forward given ``out=`` (what each flat layer runs)
    fills the slot with the sandwich's y; under autograd ``out=`` is
    refused."""
    args = _sandwich_args(dtype)
    p = ds.pack_weights(*args[1:], dtype)
    buf, slot = _slot(dtype)
    with torch.no_grad():
        want = ds.dense_sandwich_packed(args[0], p)
        ds.dense_sandwich_packed(args[0], p, out=slot)
    assert torch.equal(buf[..., 144:192], want)
    w1 = args[1].clone().requires_grad_()
    with pytest.raises(ValueError, match="out="):
        ds.dense_sandwich_packed(args[0], p._replace(w1=w1), out=slot)


# ---- the flat block against the plain block --------------------------------

@DTYPES
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_flat_block_equals_plain_block(dtype, train):
    """The flat block and the plain routed block on the same weights:
    outputs, running statistics (updated once, in train), the input's and
    every parameter's gradient."""
    state = tb.port_state()
    x, cot = tb.x_cot(dtype)
    flat = _flat_block()
    assert flat.train(train).runs_flat(
        torch.zeros(1, tb.C0, tb.S, tb.S, dtype=dtype))
    got = tb.run(flat, state, x, cot, dtype, train)
    want = tb.run(_plain_block(), state, x, cot, dtype, train)
    tb.check(tb.errors(got, want), tb.SAME[dtype])
    for k, v in state.items():
        if "running" in k:
            assert train != torch.equal(got["state"][k], v), k


def test_flat_block_counts_one_kernel_call_per_layer(monkeypatch):
    """A train call runs each forward stage and each backward stage once
    per layer (the plain versions on the CPU), as the routed plain block
    does, and one block Function."""
    calls = {}
    for name in ("fwd_stages_reference", "bwd_recompute_reference",
                 "bwd_dx_reference", "bwd_dw1_reference",
                 "bwd_dw2_reference"):
        fn = getattr(ds, name)
        monkeypatch.setattr(ds, name, lambda *a, _n=name, _f=fn: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a))[1])
    applied = []
    apply = tdn._FlatBlock.apply
    monkeypatch.setattr(tdn._FlatBlock, "apply",
                        lambda *a: applied.append(1) or apply(*a))
    x, cot = tb.x_cot(torch.float32)
    state = tb.port_state()
    tb.run(_flat_block(), state, x, cot, torch.float32)
    flat = dict(calls)
    calls.clear()
    tb.run(_plain_block(), state, x, cot, torch.float32)
    assert applied == [1]
    assert flat == calls == {k: tb.LAYERS for k in calls}
    assert len(calls) == 5


# ---- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("dtype,remat", [(torch.float32, True),
                                         (torch.bfloat16, False)],
                         ids=["f32-remat", "bf16-plain"])
def test_blocks_match_jax_dense_block(dtype, remat):
    """The port's flat block, and its plain block with the same ``remat``
    (``test_torch_remat.py``'s subject), against JAX ``DenseBlock(remat=
    remat)`` on the JAX weights, in train mode: outputs, running
    statistics and gradients (a bfloat16 block's held together, as
    test_torch_routing.py does); with remat in float32 (the default
    config's), without in bfloat16, each JAX program compiled once.
    float32 against ``fused="off"``.  bfloat16 against
    ``fused="interpret"``, the TPU kernels' dtype semantics (r rounded
    once, after the affine), which the port's kernels keep: the unrouted
    layer also rounds z before the affine, and at this block that alone
    moves the gradients by 4.7e-2."""
    x, cot = tb.x_cot(dtype, seed=4)
    fused = "off" if dtype == torch.float32 else "interpret"
    state, want = tb.jax_pair(
        jdn.DenseBlock(tb.LAYERS, tb.BN, 48, dtype=tb.JAX_DT[dtype],
                       remat=remat, fused=fused), x, cot, 5, dtype)
    for block in (_flat_block(remat=remat), _plain_block(remat=remat)):
        got = tb.run(block, state, x, cot, dtype)
        tb.check(tb.errors(got, want, together=dtype == torch.bfloat16),
                 tb.VS_JAX[dtype])


def test_flat_block_matches_jax_flat_block_interpreted():
    """Against JAX ``DenseBlockFlat(interpret=True)`` (B2f's TPU kernel
    interpreted), float32: the eval forward, and the train forward's
    output and running statistics."""
    dtype = torch.float32
    x, _ = tb.x_cot(dtype, seed=6)
    jb = jdn.DenseBlockFlat(tb.LAYERS, tb.BN, 48, dtype=tb.JAX_DT[dtype],
                            interpret=True)
    v = tb.randomize_norms(jb.init(jax.random.PRNGKey(7), jnp.asarray(x),
                                   False), 7)
    state = tb.from_jax_variables(v["params"], v["batch_stats"])
    xj = jnp.asarray(x).astype(tb.JAX_DT[dtype])
    want_eval = np.asarray(jb.apply(v, xj, False), np.float32)
    want_train, upd = jb.apply(v, xj, True, mutable=["batch_stats"])
    want_stats = tb.from_jax_variables(
        v["params"], jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    block = _flat_block()
    block.load_state_dict(state)
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    tol = tb.VS_JAX[dtype]
    with torch.no_grad():
        assert rel_l2(torch_to_nhwc(block.eval()(xt)), want_eval) < tol["out"]
        got = torch_to_nhwc(block.train()(xt))
    assert rel_l2(got, np.asarray(want_train, np.float32)) < tol["out"]
    for k, v in block.state_dict().items():
        if "running" in k:
            assert rel_l2(v.numpy(), want_stats[k].numpy()) < tol["stats"], k


# ---- routing -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "on_all", "interpret"])
def test_flat_routes_equal_jax(mode):
    """Every mode but "on" runs flat, where every layer routes both ways
    ("on_all_bwd"), the encoder's blocks the JAX package's
    ``flat_routes`` takes, in both modes of the step; no decoder block."""
    r = Routing("on_all_bwd", mode)
    for s in sorted(rt.ENCODER_SIZES):
        for train in (False, True):
            for dt in tb.DTYPES:
                assert (r.flat_block(s, train, dt)
                        == jds.flat_routes(s, train, mode)), (s, train)
    assert jds.flat_sizes(mode) == {s for s in rt.ENCODER_SIZES
                                    if r.flat_block(s, False, torch.float32)}
    assert not r.flat_block(8, False, torch.float32)


def test_flat_on_follows_the_port_tables():
    """"on" takes exactly the flat sizes of the port's measured table,
    which hold only encoder sizes, per mode of the step and dtype, where
    every layer routes."""
    r = Routing("on_all_bwd", "on")
    for dt in tb.DTYPES:
        for train in (False, True):
            table = rt.MEASURED[train, dt].flat
            assert table <= rt.ENCODER_SIZES
            assert {s for s in rt.ENCODER_SIZES
                    if r.flat_block(s, train, dt)} == table


@pytest.mark.parametrize("mode,fused,want", [
    ("auto", "on", "on"), ("auto", "on_all", "on"),
    ("auto", "on_all_bwd", "on"), ("auto", "off", "off"),
    ("on_all", "off", "on_all"), ("off", "on", "off"),
    ("interpret", "on", "interpret")])
def test_resolve_flat(mode, fused, want):
    assert Routing(fused, mode).flat == want


def test_block_runs_flat_only_where_every_layer_routes():
    """No block runs flat on the cuDNN path: it needs the forward routed,
    and in train the backward too; and a square input."""
    x = torch.zeros(1, tb.C0, tb.S, tb.S)
    cases = {("on_all_bwd", True): True, ("on_all_bwd", False): True,
             ("on_all", False): True, ("on_all", True): False,
             ("off", False): False, ("off", True): False}
    for (fused, train), want in cases.items():
        block = _flat_block(fused=fused).train(train)
        assert block.runs_flat(x) == want, (fused, train)
        assert not block.runs_flat(torch.zeros(1, tb.C0, tb.S, tb.S + 2))
    assert not _flat_block(flat="off").runs_flat(x)
    assert not _flat_block(flat="interpret").runs_flat(x)


def test_encoder_takes_the_plain_block_on_a_non_square_input(monkeypatch):
    """Device-augment init runs the encoder on a raw, non-square frame
    (250 x 333): there each of the encoder's blocks, which choose on the
    shape they get, takes the plain form; on the square crop each runs
    flat.  The flat form and the plain form's layers are stubbed: the
    choice is under test."""
    calls = []

    def flat(block, x, *_):
        calls.append(("flat", block))
        return x

    def layer(self, x):
        calls.append(("layer", self))
        return x.new_zeros((x.shape[0], 48, *x.shape[2:]))

    monkeypatch.setattr(tdn._FlatBlock, "apply", flat)
    monkeypatch.setattr(tdn.DenseLayer, "forward", layer)
    enc = tdn.Encoder(Routing("on_all_bwd", "on_all")).eval()
    blocks = ((enc.dense_e2, 96, 57), (enc.dense_e3, 192, 29),
              (enc.dense_e4, 384, 15))
    for block, c, s in blocks:
        block(torch.zeros(1, c, s, s + 6))
    assert calls == [("layer", m) for b, _, _ in blocks
                     for m in b.children()]
    calls.clear()
    for block, c, s in blocks:
        block(torch.zeros(1, c, s, s))
    assert calls == [("flat", b) for b, _, _ in blocks]


@pytest.mark.parametrize("flat,fused,want", [
    ("auto", "auto", "on"), ("off", "auto", "off"),
    ("on_all", "off", "on_all"), ("auto", "off", "off")])
def test_model_config_reaches_every_encoder_block(flat, fused, want):
    """The resolved mode reaches the encoder's three blocks; the
    decoder's block, of the same routing, never runs flat."""
    model = DepthEstimationNet(ModelConfig(flat_block=flat, fused_dense=fused))
    blocks = [m for m in model.encoder.modules()
              if isinstance(m, tdn.DenseBlock)]
    assert len(blocks) == 3
    assert {type(b) for b in blocks} == {tdn.DenseBlock}
    assert {b.routing.flat for b in blocks} == {want}
    dec = model.d_1.dense_layer
    assert dec.routing is blocks[0].routing
    for train in (False, True):
        for dt in tb.DTYPES:
            assert not dec.train(train).runs_flat(
                torch.zeros(1, 1056, 8, 8, dtype=dt))


def test_cli_flat_block_reaches_the_model():
    from md_rdm_tpu_torch.training.module import DepthTrainer
    args = cli_train.build_parser().parse_args(
        ["--dataset", "synthetic", "--flat_block", "on_all", "--device",
         "cpu"])
    config = cli_train.build_config(args)
    assert config.model.flat_block == "on_all"
    model = DepthTrainer(config, device="cpu").init(seed=0).model
    assert {m.routing.flat for m in model.encoder.modules()
            if isinstance(m, tdn.DenseBlock)} == {"on_all"}
