"""The port's measurement tools (``islam_tpu_torch/tools/``) against the
JAX package's (``tools/flops_analysis.py``).

The FLOP count of one 'vo' ``train_step`` at 64x128, B=2 on the synthetic
window, the same weights on both sides (the JAX initialisation carried over
with ``state_dict_from_jax``): the port's count under JAX's rule
(``model_tflops_jax_rule``) against ``jaxpr_flops`` of the traced JAX step,
unrounded, part by part.  Every part but PVGO is the same set of matrix
products and convolutions on both sides and is held to rtol 1e-9 (it is
equal).  The PVGO part is not: JAX's LM tries one damping a trip of its
inner while loop (bounded at 10 trips by the tool), the port tries 16 in
one batch, so the products differ in shape and number; it is held to
within 25 % of JAX's (14 % measured) and to under 1e-4 of the step.

Then the pieces: the JAX rule of single convolutions against
``eqn_flops`` of ``lax.conv_general_dilated`` (plain, strided, dilated,
depthwise, transposed, and the input and weight gradients); the useful
rule against ``FlopCounterMode``'s own count; the GRU formula against the
CPU's decomposed ``nn.GRU``; the full-size constant against ``bench.py``;
the roofline's family grouping and byte rule, and the copy tool's bytes,
on CPU ``torch.profiler`` traces of small conv and copy stacks.
"""

import re
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from islam_tpu import testing as jtesting
from islam_tpu.imu import denoiser as jdn
from islam_tpu.models import tartanvo as jtvo
from islam_tpu.train import train_step as jax_train_step
from islam_tpu_torch.imu.denoiser import IMUDenoiser
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.tools import conv_roofline, copies, flops, h100
from islam_tpu_torch.tools import window as win
from islam_tpu_torch.utils.weights import (denoiser_state_dict_from_jax,
                                           state_dict_from_jax)
from tools.flops_analysis import _as_jaxpr, eqn_flops, jaxpr_flops

from tests.test_torch_slice import shared_jax_init  # noqa: F401

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W, B = 64, 128, 2
PVGO_RTOL = 0.25          # of JAX's PVGO part
PVGO_SHARE = 1e-4         # of the step
# An op of the JAX step belongs to the innermost frame of one of these
# files (the port's ``tools/flops._PART_FILES``); the transpose of the VO
# forward is the backward.
JAX_PART_FILES = (
    ("/islam_tpu/models/pwcnet.py", "flow"),
    ("/islam_tpu/models/stereonet.py", "stereo"),
    ("/islam_tpu/models/psmnet.py", "stereo"),
    ("/islam_tpu/models/voflownet.py", "pose"),
    ("/islam_tpu/imu/denoiser.py", "denoiser"),
    ("/islam_tpu/imu/", "imu"), ("/islam_tpu/pvgo/", "pvgo"))


def _jax_part(eqn, backward):
    if backward:
        return "backward"
    for fr in eqn.source_info.traceback.frames:
        for f, part in JAX_PART_FILES:
            if f in fr.file_name:
                return part
    return "other"


def jax_parts(jaxpr, mult=1.0, backward=False, while_trip=10):
    """``jaxpr_flops`` split by part: the same walk (scan lengths, while
    loops at ``while_trip``, the costlier branch of a cond)."""
    out = dict.fromkeys(flops.PARTS, 0.0)

    def add(other, m):
        for k, v in other.items():
            out[k] += m * v

    for eqn in jaxpr.eqns:
        name, params = eqn.primitive.name, eqn.params
        bw = backward or "transpose(jvp" in str(eqn.source_info.name_stack)
        if name == "scan":
            add(jax_parts(_as_jaxpr(params["jaxpr"]), params["length"], bw),
                mult)
        elif name == "while":
            for key in ("body_jaxpr", "cond_jaxpr"):
                add(jax_parts(_as_jaxpr(params[key]), while_trip, bw), mult)
        elif name == "cond":
            branches = [jax_parts(_as_jaxpr(b), 1.0, bw)
                        for b in params["branches"]]
            add(max(branches, key=lambda p: sum(p.values())), mult)
        elif eqn_flops(eqn):
            out[_jax_part(eqn, bw)] += mult * eqn_flops(eqn)
        else:
            for v in params.values():
                for vi in (v if isinstance(v, (list, tuple)) else [v]):
                    inner = _as_jaxpr(vi)
                    if inner is not None:
                        add(jax_parts(inner, 1.0, bw), mult)
    return out


@pytest.fixture(scope="module")
def weights():
    variables = jax.device_get(jtvo.init_params(jax.random.PRNGKey(0), H, W))
    dn_params = jax.device_get(jdn.init_params(jax.random.PRNGKey(1)))
    return variables, dn_params


def _jax_count(weights, bf16):
    variables, dn_params = weights
    ds = jtesting.make_dataset(num_frames=B + 1, height=H, width=W)
    imu = jtesting.make_imu_module(ds, batch_frames=B)
    batch, win_, init = jtesting.make_step_inputs(ds, imu, 0, B)
    kw = dict(target="vo", datatype="kitti", correct_scale=False,
              use_kitti_coord=True, denoise_accel=True, denoise_gyro=False,
              loss_weight=(1.0, 0.1, 10.0, 0.1), rot_w=1.0, trans_w=0.1,
              bf16=bf16)
    args = (variables, dn_params, batch, win_, init,
            jnp.asarray(np.asarray(ds.rgb2imu_pose), jnp.float32),
            imu.gravity, imu.accel_bias, imu.gyro_bias, jnp.asarray(False))
    jaxpr = jax.make_jaxpr(lambda *a: jax_train_step(*a, **kw))(*args).jaxpr
    return jaxpr_flops(jaxpr), jax_parts(jaxpr)


def _port_count(weights, bf16):
    variables, dn_params = weights
    model = VONet(H, W)
    model.load_state_dict(state_dict_from_jax(variables))
    dn = IMUDenoiser()
    dn.load_state_dict(denoiser_state_dict_from_jax(dn_params))
    return flops.train_step_flops(H, W, B, bf16=bf16, device="cpu",
                                  model=model, denoiser=dn)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_jax_rule_count_matches_jax_part_by_part(weights, bf16):
    total, parts = _jax_count(weights, bf16)
    assert sum(parts.values()) == total  # the split is the same walk
    port = _port_count(weights, bf16)
    mine = {p: j for p, (_, j) in port["flops"]["parts"].items()}
    for part in flops.PARTS:
        if part != "pvgo":
            assert mine[part] == pytest.approx(parts[part], rel=1e-9,
                                               abs=0), part
    assert parts["flow"] > 0 and parts["stereo"] > 0 and parts["pose"] > 0
    assert parts["denoiser"] > 0 and parts["backward"] > 0
    pvgo, jpvgo = mine["pvgo"], parts["pvgo"]
    assert jpvgo > 0 and abs(pvgo - jpvgo) <= PVGO_RTOL * jpvgo
    assert abs(pvgo - jpvgo) <= PVGO_SHARE * total
    assert port["flops"]["jax_rule"] - pvgo == pytest.approx(
        total - jpvgo, rel=1e-9, abs=0)
    assert port["model_tflops_jax_rule"] * 1e12 == port["flops"]["jax_rule"]
    # the useful count differs by the transposed convolutions' zeros, the
    # strided convolutions' input gradients and the resizes
    diff = port["jax_rule_minus_model_tflops"]["by_kind"]
    assert set(diff) <= {"transposed_conv", "conv_grad", "resize", "solve"}
    assert diff["transposed_conv"] > 0 and diff["resize"] > 0
    assert port["correlation"]["calls_b_c_h_w"] == [
        [B, c, H >> s, W >> s] for c, s in
        ((196, 6), (128, 5), (96, 4), (64, 3), (32, 2))]


def test_useful_count_is_flop_counter_modes_own():
    """The useful rule is ``FlopCounterMode``'s count, op for op, on a
    conv stack with a strided, a dilated, a grouped and a transposed
    convolution, forward and backward, and the JAX rule differs only where
    JAX dilates the input."""
    torch.manual_seed(0)
    net = nn.Sequential(nn.Conv2d(3, 8, 3, 2, 1), nn.Conv2d(8, 8, 3, 1, 2, 2),
                        nn.Conv2d(8, 8, 3, 1, 1, groups=4),
                        nn.ConvTranspose2d(8, 4, 4, 2, 1), nn.Linear(16, 5))
    x = torch.randn(2, 3, 16, 16, requires_grad=True)

    def run():
        net(x).sum().backward()

    with FlopCounterMode(display=False) as ref:
        run()
    count, _ = flops.count_step(run)
    assert count.total("useful") == ref.get_total_flops() > 0
    kinds = {o.kind for o in count.ops}
    assert kinds == {"conv", "transposed_conv", "conv_grad", "matmul"}
    grouped = [o for o in count.ops if o.module == "Sequential.2"]
    for o in count.ops:
        if o.kind in ("conv", "matmul"):
            assert o.jax_rule == o.useful, o
        elif o not in grouped:
            assert o.jax_rule >= o.useful, o
    # JAX dilates the strided convolution's gradient and the transposed
    # convolution's input
    assert all(o.jax_rule > o.useful for o in count.ops
               if o.module in ("Sequential.0", "Sequential.3")
               and o.kind != "conv")
    # FlopCounterMode's weight gradient of a grouped convolution ignores the
    # groups (4 here): it counts 4x the products; JAX's rule does not
    bw = next(o for o in grouped if o.kind == "conv_grad")
    true = 2 * (8 * 2 * 3 * 3) * 2 * 8 * 8
    assert bw.jax_rule == 2 * true and bw.useful == true + 4 * true


def _jax_conv_flops(fn, *args):
    """``eqn_flops`` of the one convolution ``fn`` traces to."""
    eqns = [e for e in jax.make_jaxpr(fn)(*args).jaxpr.eqns
            if e.primitive.name == "conv_general_dilated"]
    assert len(eqns) == 1
    return eqn_flops(eqns[0])


CONV_CASES = {  # (B, Cin, H, W), Cout, k, stride, padding, dilation, groups
    "plain": ((2, 6, 12, 10), 8, 3, 1, 1, 1, 1),
    "strided": ((2, 6, 12, 10), 8, 3, 2, 1, 1, 1),
    "dilated": ((2, 6, 12, 10), 8, 3, 1, 2, 2, 1),
    "depthwise": ((2, 6, 12, 10), 6, 3, 1, 1, 1, 6),
    "grouped_strided": ((1, 6, 13, 9), 4, 5, 3, 2, 1, 2),
}


def _lax_conv(x, w, stride, padding, dilation, groups, lhs_dilation=1):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), [(padding, padding)] * 2,
        lhs_dilation=(lhs_dilation,) * 2, rhs_dilation=(dilation,) * 2,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_jax_rule_matches_eqn_flops(case):
    xs, cout, k, s, p, d, g = CONV_CASES[case]
    x = jnp.zeros(xs, jnp.float32)
    w = jnp.zeros((cout, xs[1] // g, k, k), jnp.float32)

    def fwd(x, w):
        return _lax_conv(x, w, s, p, d, g)

    out = jax.eval_shape(fwd, x, w).shape
    assert flops.conv_jax_rule(xs, w.shape, out, g) == _jax_conv_flops(
        fwd, x, w)
    # the torch convolution of the same shapes: the same output
    tout = torch.nn.functional.conv2d(
        torch.zeros(xs), torch.zeros(w.shape), stride=s, padding=p,
        dilation=d, groups=g).shape
    assert tuple(tout) == tuple(out)
    assert conv_roofline.conv_output_shape(
        xs, w.shape, (s, s), (p, p), (d, d), False, (0, 0), g) == tuple(out)
    # the gradients JAX's transpose rules emit
    g_out = jnp.zeros(out, jnp.float32)
    _, vjp_x = jax.vjp(lambda x: fwd(x, w), x)
    _, vjp_w = jax.vjp(lambda w: fwd(x, w), w)
    assert flops.conv_backward_jax_rule(
        out, xs, w.shape, g, (True, False)) == _jax_conv_flops(vjp_x, g_out)
    assert flops.conv_backward_jax_rule(
        out, xs, w.shape, g, (False, True)) == _jax_conv_flops(vjp_w, g_out)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (3, 2, 1), (5, 3, 2)])
def test_transposed_conv_jax_rule_matches_eqn_flops(k, s, p):
    """``ConvTranspose2d(cin, cout, k, s, p)`` is, in JAX, a convolution of
    the flipped kernel over the input dilated by s, padded by k-1-p."""
    xs, cout = (2, 6, 7, 5), 4
    x = jnp.zeros(xs, jnp.float32)
    w = jnp.zeros((cout, xs[1], k, k), jnp.float32)

    def fwd(x, w):
        return _lax_conv(x, w, 1, k - 1 - p, 1, 1, lhs_dilation=s)

    out = jax.eval_shape(fwd, x, w).shape
    tw = (xs[1], cout, k, k)  # torch's (in, out, k, k)
    tout = torch.nn.functional.conv_transpose2d(
        torch.zeros(xs), torch.zeros(tw), stride=s, padding=p).shape
    assert tuple(tout) == tuple(out)
    assert conv_roofline.conv_output_shape(
        xs, tw, (s, s), (p, p), (1, 1), True, (0, 0), 1) == tuple(out)
    assert flops.conv_jax_rule(xs, tw, out, 1) == _jax_conv_flops(fwd, x, w)
    assert flops.conv_jax_rule(xs, tw, out, 1) > flops.conv_useful(
        xs, tw, out, True)


def test_resize_and_solve_jax_rules_match_eqn_flops():
    """The JAX package's resizes (islam_tpu/models/layers.py) and
    ``jnp.linalg.inv``, walked as ``jaxpr_flops`` walks them."""
    from islam_tpu.models import layers

    for (h, w), (ho, wo), ac in [((8, 10), (16, 20), False),
                                 ((8, 10), (4, 5), False),
                                 ((8, 10), (12, 14), False),
                                 ((8, 10), (16, 20), True)]:
        x = jnp.zeros((2, h, w, 3), jnp.float32)  # NHWC
        jp = jax.make_jaxpr(lambda x: layers.resize_bilinear(
            x, (ho, wo), align_corners=ac))(x).jaxpr
        assert flops.resize_jax_rule((2, 3, h, w), (2, 3, ho, wo), ac) == \
            jaxpr_flops(jp)
    a = jnp.eye(3, dtype=jnp.float32)[None].repeat(2, 0)
    assert flops.solve_jax_rule((2, 3, 3), 3) == jaxpr_flops(
        jax.make_jaxpr(jnp.linalg.inv)(a).jaxpr)
    assert flops.solve_jax_rule((2, 3, 3), 1) == jaxpr_flops(
        jax.make_jaxpr(jnp.linalg.solve)(a, jnp.ones((2, 3, 1))).jaxpr)


def test_gru_formula_is_the_cpus_decomposed_gru():
    """On the CPU ``nn.GRU`` decomposes into counted matrix products; on
    the card it is one cuDNN call, counted by ``rnn_flops`` and
    ``rnn_backward_flops``: the same numbers."""
    torch.manual_seed(0)
    T, N, inp, hid = 7, 3, 5, 6
    gru = nn.GRU(inp, hid)
    x = torch.randn(T, N, inp, requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        out, _ = gru(x)
    assert fwd.get_total_flops() == flops.rnn_flops(T, N, inp, hid, 3)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    assert bwd.get_total_flops() == flops.rnn_backward_flops(
        T, N, inp, hid, 3, (True, False, False, True))
    # and JAX's _gru_scan of the denoiser's shapes (T tokens, N=1)
    p = jdn.init_params(jax.random.PRNGKey(1))["gru"]
    jp = jax.make_jaxpr(lambda x: jdn._gru_scan(p, x))(
        jnp.zeros((T, 64), jnp.float32)).jaxpr
    assert jaxpr_flops(jp) == flops.rnn_flops(T, 1, 64, 128, 3)


def test_full_size_constant_is_benchs():
    src = (ROOT / "bench.py").read_text()
    const = float(re.search(r"^MODEL_TFLOPS_FALLBACK = ([\d.]+)", src,
                            re.M).group(1))
    assert flops.FULL_JAX_RULE_TFLOPS == const


def test_h100_constants_and_corr_bound():
    from islam_tpu_torch import bench_corr
    assert h100.peak_flop_per_s(torch.float32) == 67e12
    assert h100.peak_flop_per_s(torch.float32, tf32=True) == 494.7e12
    assert h100.peak_flop_per_s(torch.bfloat16) == 989e12
    # PERF.md's bound column: one 448x640, B=8 VO forward's five levels
    for dtype, ms in (("float32", 0.0379), ("bfloat16", 0.0190)):
        total = sum(bench_corr.bound_ms((8, *lv), dtype)[0]
                    for lv in bench_corr.LEVELS)
        assert round(total, 4) == ms


class _Stack(nn.Module):
    def __init__(self):
        super().__init__()
        self.down = nn.Conv2d(3, 8, 3, 2, 1)
        self.up = nn.ConvTranspose2d(8, 4, 4, 2, 1)

    def forward(self, x):
        return self.up(torch.relu(self.down(x)))


def _trace(fn, **kw):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 **kw) as prof:
        fn()
    return prof


def test_roofline_families_and_bytes_on_a_cpu_trace():
    torch.manual_seed(0)
    net = _Stack()
    x = torch.randn(2, 3, 16, 16)
    named = {m: "net." + n if n else "net" for n, m in net.named_modules()}

    def run():
        with win.module_ranges(named):
            for _ in range(2):
                net(x).sum().backward()

    prof = _trace(run)
    events = prof.events()
    fams = conv_roofline.families(events, win.dtypes_by_id(prof),
                                  win.Modules(events))
    by = {(k[1], k[-1]): f for k, f in fams.items()}
    assert set(by) == {((2, 3, 16, 16), "forward"),
                       ((2, 8, 8, 8), "forward"),
                       ((2, 3, 16, 16), "backward[weight]"),
                       ((2, 8, 8, 8), "backward[input][weight]")}
    assert all(len(f["convs"]) == 2 for f in fams.values())
    down = by[((2, 3, 16, 16), "forward")]
    c = down["convs"][0]
    assert down["module"] == "net.down"
    assert c.shapes["output"] == (2, 8, 8, 8)
    assert c.bytes == 4 * (2 * 3 * 16 * 16 + 8 * 3 * 3 * 3 + 2 * 8 * 8 * 8)
    assert c.flops == flops.conv_useful((2, 3, 16, 16), (8, 3, 3, 3),
                                        (2, 8, 8, 8), False)
    up = by[((2, 8, 8, 8), "forward")]["convs"][0]
    assert up.shapes["output"] == (2, 4, 16, 16)
    assert up.key[7] is True  # transposed
    bw = by[((2, 8, 8, 8), "backward[input][weight]")]
    assert bw["module"] == "net.up (backward)"
    g = bw["convs"][0]
    # dy once; W and dx for the input gradient; x and dW for the weight's
    assert g.bytes == 4 * (2 * 4 * 16 * 16 + 2 * (8 * 4 * 4 * 4)
                           + 2 * (2 * 8 * 8 * 8))
    assert by[((2, 3, 16, 16), "backward[weight]")]["convs"][0].bytes == \
        4 * (2 * 8 * 8 * 8 + 2 * 3 * 16 * 16 + 8 * 3 * 3 * 3)
    rows = conv_roofline.family_rows(fams, 2, False)
    assert [r["calls"] for r in rows] == [2] * 4
    assert all(r["label"] is None for r in rows)  # no device time here


def test_copy_bytes_on_a_cpu_trace():
    a = torch.randn(2, 4, 8, 8)
    b = torch.randn(2, 5, 8, 8)

    def run():
        torch.cat([a, b], 1)
        a.to(torch.bfloat16)
        a.permute(0, 2, 3, 1).contiguous()
        a.contiguous()  # contiguous already: no copy
        a.clone()

    prof = _trace(run, with_stack=True, profile_memory=True,
                  experimental_config=torch.profiler._ExperimentalConfig(
                      verbose=True))
    events = prof.events()
    rows = copies.copy_rows(events, win.dtypes_by_id(prof),
                            win.Modules(events))
    got = {k[0]: (v[0], v[1]) for k, v in rows.items()}
    n = 2 * 4 * 8 * 8
    assert got == {"aten::cat": (1, 2 * 4 * (n + 2 * 5 * 8 * 8)),
                   "aten::to": (1, 4 * n + 2 * n),
                   "aten::contiguous": (1, 8 * n),
                   "aten::clone": (1, 8 * n)}


def test_op_bytes_on_a_cpu_trace():
    """Other ops: arguments read once, the allocated output written once;
    an in-place op writes its largest argument; a cat reads what it
    writes."""
    a = torch.randn(2, 4, 8, 8)
    b = torch.randn(2, 5, 8, 8)

    def run():
        torch.add(a, a)
        a.relu_()
        torch.cat([a, b], 1)

    prof = _trace(run, profile_memory=True)
    dtypes = win.dtypes_by_id(prof)
    got = {e.name: conv_roofline.op_bytes(e, dtypes) for e in prof.events()
           if e.name in ("aten::add", "aten::relu_", "aten::cat")}
    n = 4 * 2 * 4 * 8 * 8
    assert got == {"aten::add": 3 * n, "aten::relu_": 2 * n,
                   "aten::cat": 2 * (n + 4 * 2 * 5 * 8 * 8)}
