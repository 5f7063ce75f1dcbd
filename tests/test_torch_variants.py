"""The front-end variants against the JAX package at 64x128, B=2.

PWC-Net with uncertainty heads and the concat-free decoder, the flow and
stereo losses, both PSMNets, the multi-camera pose head, the parts-aware
and 3-D layers, and the small geometry and IMU leftovers (``join_flow``,
``motion2pose``/``pose2motion_se3``, ``frame_states``,
``denoise_and_integrate``).

Parameters: each JAX module's own variables tree, from ``jax.eval_shape``
of its ``init`` (flax's init compiles for 16-48 s a network on the CPU;
the shapes come in seconds), filled from a seed: conv and Dense kernels
normal with variance 2 / fan-in, biases and BatchNorm shifts and means
nonzero, variances in [0.5, 1.5].  Flax's init leaves biases at 0 and the
running stats at (0, 1), which would hide a bias added twice or a wrong
stat.  ``state_dict_from_jax`` carries the tree to the port.  JAX runs
jitted: one compile per function held against.

Tolerances: networks rtol 1e-3 and atol 1e-4 of the output's scale, as in
tests/test_torch_models.py (float32 convolution stacks summing in other
orders); geometry and IMU functions 1e-5.  Gradients are held at the
network tolerance in float64 on both sides (``jax.enable_x64``): in
float32, the train-mode BatchNorm backward (a mean subtracted from the
upstream gradient) and the warp's in-bounds threshold turn 1e-6 summation
differences into up to 1e-2 (measured at 64x128: 0.6 % relative L2 at the
PSMNet's first conv; 2 of 134,784 elements of a PWC decoder conv at 0.6 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)

H, W, B = 64, 128, 2


def jax_variables(module, *args, seed=0):
    """``module.init``'s variables tree, filled from ``seed`` (numpy)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.normal(size=s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:  # bias, mean
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(x), -1, 1)))


def _numpy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, scale=None):
    port, ref = _numpy(port), _numpy(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(port, ref, rtol=1e-3, atol=1e-4 * scale + 1e-7)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _grads_close(port_model, jax_grads):
    """Port parameter gradients against JAX's, carried to the port's keys;
    each tensor at the network tolerance on the largest gradient."""
    ref = state_dict_from_jax(jax.device_get(jax_grads))
    got = {k: p.grad for k, p in port_model.named_parameters()}
    assert set(got) == set(ref)
    gmax = max(float(v.abs().max()) for v in ref.values())
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=k)


def _images(seed, n=B, c=6, h=H, w=W, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, h, w, c)) * scale
            ).astype(np.float32)


def _roundtrip(model, tmp_path):
    """A .pkl of ``model`` loads into a fresh copy bitwise."""
    import copy

    from islam_tpu_torch.utils import checkpoints as ckpt

    path = tmp_path / "model.pkl"
    torch.save(model.state_dict(), path)
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for t in fresh.state_dict(keep_vars=True).values():
            t.zero_()
    loaded = ckpt.import_torch_weights(fresh, ckpt.load_torch_state_dict(
        str(path)))
    assert sorted(loaded) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class TestLayers:
    def test_conv_parts_and_convt2d_parts(self):
        """A conv and a transposed conv of channel parts equal JAX's
        PartsConv / ConvT2d of the same parts (bias added once)."""
        from islam_tpu.models.layers import ConvT2d as JConvT2d
        from islam_tpu.models.layers import PartsConv
        from islam_tpu_torch.models.layers import ConvT2d, conv_parts

        rng = np.random.default_rng(1)
        a, b = (rng.normal(size=(2, 9, 13, c)).astype(np.float32)
                for c in (5, 3))
        jconv = PartsConv(7, (3, 3), (1, 1), (2, 2), (2, 2))
        v = jax_variables(jconv, (a, b), seed=2)
        ref = jconv.apply(v, (a, b))
        conv = torch.nn.Conv2d(8, 7, 3, 1, 2, 2)
        sd = state_dict_from_jax({"params": {"conv1a": {"conv": v["params"]}}})
        conv.load_state_dict({k.split(".", 2)[2]: t for k, t in sd.items()})
        parts = (_nchw(a), _nchw(b))
        _close(conv_parts(conv, parts), np.moveaxis(np.asarray(ref), -1, 1))
        _close(conv_parts(conv, parts), conv(torch.cat(parts, 1)))

        jt = JConvT2d(6, 4, 2, 1)
        vt = jax_variables(jt, (a, b), seed=3)
        sd = state_dict_from_jax({"params": {"deconv6": vt["params"]}})
        convt = ConvT2d(8, 6, 4, 2, 1)
        convt.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
        _close(convt(parts), np.moveaxis(np.asarray(jt.apply(vt, (a, b))),
                                         -1, 1))
        _close(convt(parts), convt(torch.cat(parts, 1)))

    def test_convt3d(self):
        from islam_tpu.models.layers import ConvT3d as JConvT3d
        from islam_tpu_torch.models.layers import ConvT3d

        x = np.random.default_rng(4).normal(size=(2, 3, 4, 5, 6)).astype(
            np.float32)
        jm = JConvT3d(5, 3, 2, 1, output_padding=1, use_bias=False)
        v = jax_variables(jm, x, seed=5)
        sd = state_dict_from_jax({"params": {"dres2": {"conv5_conv":
                                                       v["params"]}}})
        m = ConvT3d(6, 5)
        m.load_state_dict({"weight": sd["dres2.conv5.0.weight"]})
        ref = np.moveaxis(np.asarray(jm.apply(v, x)), -1, 1)
        out = m(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
        assert out.shape == (2, 5, 6, 8, 10)
        _close(out, ref)

    @pytest.mark.parametrize("mode", ["bilinear", "nearest"])
    @pytest.mark.parametrize("scale", [0.25, 0.5, 4])
    def test_interpolate_scale(self, mode, scale):
        from islam_tpu.models.layers import interpolate_scale as jis
        from islam_tpu_torch.models.layers import interpolate_scale

        x = np.random.default_rng(6).normal(size=(2, 12, 20, 3)).astype(
            np.float32)
        ref = np.moveaxis(np.asarray(jis(jnp.asarray(x), scale, mode)), -1, 1)
        out = interpolate_scale(_nchw(x), scale, mode)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# PWC-Net: uncertainty heads, the concat-free decoder, the flow losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pwc_unc():
    from islam_tpu.models.pwcnet import PWCDCNet as JPWC
    from islam_tpu_torch.models.pwcnet import PWCDCNet

    x = _images(7, scale=0.3)
    jm = JPWC(uncertainty=True)
    v = jax_variables(jm, x, seed=8)
    model = PWCDCNet(uncertainty=True)
    model.load_state_dict(state_dict_from_jax(jax.device_get(v)))
    return x, jax.jit(jm.apply)(v, x), model


def test_pwc_uncertainty_flows_and_uncertainties(pwc_unc):
    x, (jflows, juncs), model = pwc_unc
    with torch.no_grad():
        flows, uncs = model(_nchw(x))
    assert flows[0].shape == (B, 2, H // 4, W // 4)
    assert uncs[0].shape == (B, 1, H // 4, W // 4)
    for o, r in zip(flows + uncs, tuple(jflows) + tuple(juncs)):
        _close(o, np.moveaxis(np.asarray(r), -1, 1))


def test_pwc_uncertainty_keys_are_the_references(pwc_unc, tmp_path):
    """The flow convs sit at ``.pred`` and the heads at ``.unc.{0,2,4}``
    (islam_tpu/utils/checkpoints.py:33-47); a .pkl round-trips bitwise, and
    the plain net and the uncertainty net read each other's flow convs."""
    from islam_tpu_torch.models.pwcnet import PWCDCNet
    from islam_tpu_torch.utils import checkpoints as ckpt

    _, _, model = pwc_unc
    keys = set(model.state_dict())
    for lvl in (2, 3, 4, 5, 6):
        assert {f"predict_flow{lvl}.pred.weight",
                f"predict_flow{lvl}.pred.bias"} <= keys
        assert {f"predict_flow{lvl}.unc.{i}.{leaf}" for i in (0, 2, 4)
                for leaf in ("weight", "bias")} <= keys
        assert f"predict_flow{lvl}.weight" not in keys
    assert {"dc_conv7.pred.weight", "dc_conv7.unc.4.bias"} <= keys
    assert "dc_conv7.weight" not in keys
    _roundtrip(model, tmp_path)

    # the decoders below level 6 take one channel more with uncertainty,
    # so of the flow convs those of level 6 and the refiner fit both nets
    plain = PWCDCNet()
    loaded = ckpt.import_torch_weights(plain, model.state_dict())
    assert {"predict_flow6.weight", "dc_conv7.bias"} <= set(loaded)
    assert torch.equal(plain.predict_flow6.weight,
                       model.predict_flow6.pred.weight)
    back = PWCDCNet(uncertainty=True)
    loaded = ckpt.import_torch_weights(back, plain.state_dict())
    assert "predict_flow6.pred.bias" in loaded
    assert torch.equal(back.dc_conv7.pred.weight, plain.dc_conv7.weight)


@pytest.fixture(scope="module")
def pwc_plain():
    from islam_tpu.models.pwcnet import PWCDCNet as JPWC
    from islam_tpu_torch.models.pwcnet import PWCDCNet

    x = _images(9, scale=0.3)
    v = jax_variables(JPWC(), x, seed=10)
    model = PWCDCNet()
    model.load_state_dict(state_dict_from_jax(jax.device_get(v)))
    return x, v, model


def test_concat_free_against_jax_and_the_default(pwc_plain):
    """The concat-free decoder in float32: the JAX package's concat-free
    outputs, and the port's default outputs (atol 2e-5, as
    tests/test_variants.py); in float64, its gradients of sum(flows^2)
    against the default decoder's (the same modules)."""
    from islam_tpu.models.pwcnet import PWCDCNet as JPWC

    x, v, model = pwc_plain
    xt = _nchw(x)
    with torch.no_grad():
        cf, base = model(xt, concat_free=True), model(xt)
    ref, _ = jax.jit(JPWC(concat_free=True).apply)(v, x)
    for o, r, b in zip(cf, ref, base):
        _close(o, np.moveaxis(np.asarray(r), -1, 1))
        np.testing.assert_allclose(o.numpy(), b.numpy(), atol=2e-5)

    m64 = model.double()
    try:
        grads = []
        for concat_free in (True, False):
            m64.zero_grad()
            sum(torch.sum(f ** 2) for f in m64(
                xt.double(), concat_free=concat_free)).backward()
            grads.append({k: p.grad.clone()
                          for k, p in m64.named_parameters()})
        gmax = max(float(g.abs().max()) for g in grads[1].values())
        for k, g in grads[0].items():
            np.testing.assert_allclose(g.numpy(), grads[1][k].numpy(),
                                       rtol=1e-3, atol=1e-4 * gmax, err_msg=k)
    finally:
        model.float().zero_grad()


def _criterion_jax(a, b):
    return jnp.mean(jnp.abs(a - b))


def _criterion(a, b):
    return torch.mean(torch.abs(a - b))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("unc", [False, True], ids=["plain", "unc"])
@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_calc_flow_loss(training, mask, unc, small):
    from islam_tpu.models.pwcnet import calc_flow_loss as jloss
    from islam_tpu_torch.models.pwcnet import calc_flow_loss

    rng = np.random.default_rng(11)
    h, w = H // 4, W // 4
    outs = [rng.normal(size=(B, h >> k, w >> k, 2)).astype(np.float32)
            for k in range(5)]
    uncs = ([rng.normal(size=(B, h >> k, w >> k, 1)).astype(np.float32)
             for k in range(5)] if unc else None)
    th, tw = (h, w) if small else (H, W)
    target = rng.normal(size=(B, th, tw, 2)).astype(np.float32)
    # training masks supervise m < 0.5 or m > 1; eval masks m < 10
    m = (rng.uniform(0, 1.5 if training else 20, (B, th, tw, 1))
         .astype(np.float32) if mask else None)
    ref = jloss([jnp.asarray(o) for o in outs], jnp.asarray(target),
                _criterion_jax, None if m is None else jnp.asarray(m),
                None if uncs is None else [jnp.asarray(u) for u in uncs],
                lamb=0.7, training=training)
    got = calc_flow_loss([_nchw(o) for o in outs], _nchw(target),
                         _criterion, None if m is None else _nchw(m),
                         None if uncs is None else [_nchw(u) for u in uncs],
                         lamb=0.7, training=training)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("unc", [False, True], ids=["plain", "unc"])
def test_stereo_loss(mask, unc):
    from islam_tpu.models.stereonet import stereo_loss as jloss
    from islam_tpu_torch.models.stereonet import stereo_loss

    rng = np.random.default_rng(12)
    out, tgt, u = (rng.normal(size=(B, 16, 32, 1)).astype(np.float32)
                   for _ in range(3))
    m = rng.uniform(size=(B, 16, 32, 1)) > 0.3 if mask else None
    ref = jloss(jnp.asarray(out), jnp.asarray(tgt), _criterion_jax,
                None if m is None else jnp.asarray(m),
                jnp.asarray(u) if unc else None, lamb=0.7)
    got = stereo_loss(_nchw(out), _nchw(tgt), _criterion,
                      None if m is None else _nchw(m),
                      _nchw(u) if unc else None, lamb=0.7)
    assert (got[1] is None) == (ref[1] is None)
    for g, r in zip(got, ref):
        if r is not None:
            np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


# ---------------------------------------------------------------------------
# PSMNets
# ---------------------------------------------------------------------------

def test_psmnet_stackhourglass(tmp_path):
    """Eval mode (running stats): the disparity; training mode (batch
    statistics, the three predictions): the outputs and one gradient of
    their sum.  Keys: the reference's (``_psmnet_key``), a .pkl bitwise."""
    from islam_tpu.models.psmnet import PSMNetStackHourglass as JPSM
    from islam_tpu_torch.models.psmnet import PSMNetStackHourglass

    x = _images(13, scale=0.3)
    v = jax_variables(JPSM(maxdisp=16), x, seed=14)
    sd = state_dict_from_jax(jax.device_get(v))
    assert {"dres2.conv1.0.0.weight", "dres2.conv2.1.running_var",
            "dres3.conv5.0.weight", "dres4.conv6.1.bias",
            "classif3.2.weight", "dres0.2.1.weight",
            "feature_extraction.layer2.15.conv2.1.weight",
            "feature_extraction.lastconv.2.weight"} <= set(sd)

    ev = PSMNetStackHourglass(maxdisp=16, train_bn=False)
    ev.load_state_dict(sd)
    ref, _ = jax.jit(JPSM(maxdisp=16, train_bn=False).apply)(v, x)
    with torch.no_grad():
        disp, none = ev(_nchw(x))
    assert none is None and disp.shape == (B, 1, H, W)
    _close(disp, ref)
    _roundtrip(ev, tmp_path)

    tr = PSMNetStackHourglass(maxdisp=16, train_bn=True, training_mode=True)
    tr.load_state_dict(sd)
    jtr = JPSM(maxdisp=16, train_bn=True, training_mode=True)

    def loss(v, x):
        (preds, _), _ = jtr.apply(v, x, mutable=["batch_stats"])
        return sum(jnp.sum(p) for p in preds), preds

    with jax.enable_x64(True):
        (_, jpreds), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(_f64(v), np.float64(x))
    with torch.no_grad():
        preds, _ = tr(_nchw(x))
    for p, r in zip(preds, jpreds):
        _close(p, r)
    tr.double()
    preds, _ = tr(_nchw(x).double())
    sum(p.sum() for p in preds).backward()
    _grads_close(tr, {"params": grads["params"]})


def test_psmnet_basic():
    """Outputs with the running stats and with batch statistics (the
    gradient of the shared layers is held in the stacked hourglass's
    test)."""
    from islam_tpu.models.psmnet import PSMNetBasic as JPSM
    from islam_tpu_torch.models import psmnet
    from islam_tpu_torch.models.psmnet import PSMNetBasic

    left, right = _images(15, c=3, scale=0.3), _images(16, c=3, scale=0.3)
    v = jax_variables(JPSM(maxdisp=16), left, right, seed=17)
    sd = state_dict_from_jax(jax.device_get(v))
    assert {"dres4.2.0.weight", "classify.2.weight",
            "classify.0.1.running_mean"} <= set(sd)
    ev = PSMNetBasic(maxdisp=16, train_bn=False)
    ev.load_state_dict(sd)
    ref = jax.jit(JPSM(maxdisp=16, train_bn=False).apply)(v, left, right)
    with torch.no_grad():
        _close(ev(_nchw(left), _nchw(right)), ref)

    tr = psmnet.init_model(basic=True, seed=1, device="cpu", maxdisp=16)
    assert isinstance(tr, PSMNetBasic) and tr.train_bn
    tr.load_state_dict(sd)
    ref, _ = jax.jit(lambda v, a, b: JPSM(maxdisp=16).apply(
        v, a, b, mutable=["batch_stats"]))(v, left, right)
    with torch.no_grad():
        _close(tr(_nchw(left), _nchw(right)), ref)


# ---------------------------------------------------------------------------
# the multi-camera pose head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stereo,enc,heads", [(2.1, 2, 3), (2.2, 2, 3),
                                              (2.1, 0, 4)],
                         ids=["2.1", "2.2", "2.1-sincos-4heads"])
def test_voflowres_multicam(stereo, enc, heads, tmp_path):
    from islam_tpu.models.voflownet import VOFlowRes as JVOFlowRes
    from islam_tpu_torch.models.voflownet import VOFlowRes

    rng = np.random.default_rng(18)
    h, w = H // 4, W // 4
    x = rng.normal(size=(B, h, w, 6)).astype(np.float32)
    ext = rng.normal(size=(B, 6)).astype(np.float32)
    jm = JVOFlowRes(stereo=stereo, extrinsic_encoder_layers=enc,
                    trans_head_layers=heads)
    v = jax_variables(jm, x, ext, seed=19)
    sd = state_dict_from_jax(jax.device_get(v))
    model = VOFlowRes(h, w, stereo=stereo, extrinsic_encoder_layers=enc,
                      trans_head_layers=heads)
    model.load_state_dict(sd)
    assert ("feat_net2.3.0.conv1.0.weight" in sd) == (stereo == 2.2)
    assert ("extrinsic_fc2.0.weight" in sd) == (enc == 2)
    assert ("trans_head_mid0.0.weight" in sd) == (heads == 4)
    assert {"fcAB_trans.0.weight", "fcAC_trans.0.bias",
            "trans_head_fc1.0.weight", "trans_head_fc2.0.weight",
            "trans_head_fc3.weight", "voflow_rot.2.weight"} <= set(sd)
    ref = jax.jit(jm.apply)(v, x, ext)
    with torch.no_grad():
        out = model(_nchw(x), torch.from_numpy(ext))
    assert out.shape == (B, 6)
    _close(out, ref)
    _roundtrip(model, tmp_path)


# ---------------------------------------------------------------------------
# geometry and IMU leftovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "zero", "outside"])
def test_join_flow(case):
    """Random flows; zero flows (the reference's -0.5 shift per hop in the
    interior); flows that leave the image (the -1 sentinel)."""
    from islam_tpu.ops.warp import join_flow as jjoin
    from islam_tpu_torch.ops.warp import join_flow

    h, w = 12, 20
    rng = np.random.default_rng(20)
    flows = {"random": [rng.normal(0, 2, (2, h, w)) for _ in range(3)],
             "zero": [np.zeros((2, h, w))] * 2,
             "outside": [np.full((2, h, w), 1000.0),
                         rng.normal(0, 2, (2, h, w))]}[case]
    flows = [f.astype(np.float32) for f in flows]
    ref = np.asarray(jjoin([jnp.asarray(f) for f in flows], h, w))
    out = join_flow([torch.from_numpy(f) for f in flows], h, w).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if case == "zero":
        np.testing.assert_allclose(out[:, 2:-2, 2:-2], -1.0, atol=1e-5)
    if case == "outside":
        uv = np.stack(np.meshgrid(np.arange(w), np.arange(h)))
        np.testing.assert_allclose(out, -1.0 - uv, atol=1e-5)


@pytest.mark.parametrize("t0", [False, True], ids=["identity", "T0"])
def test_motion2pose_and_back(t0):
    from islam_tpu import transformation as jtr
    from islam_tpu_torch import transformation as tr

    rng = np.random.default_rng(21)
    motion = np.concatenate([rng.normal(size=(11, 3)),
                             0.3 * rng.normal(size=(11, 3))], 1).astype(
        np.float32)
    q = np.array([0.1, 0.2, 0.3, 0.9])
    T0 = (np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])
          .astype(np.float32) if t0 else None)
    ref = jax.jit(lambda m, t: jtr.motion2pose(m, t).data)(
        jnp.asarray(motion), None if T0 is None else jnp.asarray(T0))
    poses = tr.motion2pose(torch.from_numpy(motion),
                           None if T0 is None else torch.from_numpy(T0))
    assert poses.data.shape == (12, 7)
    np.testing.assert_allclose(poses.data.numpy(), np.asarray(ref),
                               atol=1e-5)
    back = tr.pose2motion_se3(poses.data)
    np.testing.assert_allclose(
        back.data.numpy(),
        np.asarray(jtr.pose2motion_se3(jnp.asarray(ref)).data), atol=1e-5)
    np.testing.assert_allclose(back.data.numpy(), np.asarray(
        jtr.cvt_se3(jnp.asarray(motion)).data), atol=1e-5)


def test_frame_states_with_an_empty_frame():
    from islam_tpu.imu import preintegrator as jpre
    from islam_tpu_torch.imu import preintegrator as pre

    rng = np.random.default_rng(22)
    S = 23
    states = [rng.normal(size=(S, n)).astype(np.float32) for n in (3, 4, 3)]
    init = [rng.normal(size=n).astype(np.float32) for n in (3, 4, 3)]
    ends = np.array([-1, 4, 9, 9, 22])
    ref = jpre.frame_states(jpre.IMUState(*map(jnp.asarray, states)),
                            jpre.IMUState(*map(jnp.asarray, init)),
                            jnp.asarray(ends))
    out = pre.frame_states(pre.IMUState(*map(torch.from_numpy, states)),
                           pre.IMUState(*map(torch.from_numpy, init)),
                           torch.from_numpy(ends))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
    np.testing.assert_array_equal(out.pos[0].numpy(), init[0])


@pytest.mark.parametrize("n_valid", [None, 37], ids=["all", "padded"])
def test_denoise_and_integrate(n_valid):
    from islam_tpu.imu import denoiser as jdn
    from islam_tpu.imu.preintegrator import IMUState as JState
    from islam_tpu_torch.imu import denoiser as dn
    from islam_tpu_torch.imu.preintegrator import IMUState
    from islam_tpu_torch.utils.weights import denoiser_state_dict_from_jax

    params = jax.device_get(jdn.init_params(jax.random.PRNGKey(3)))
    model = dn.IMUDenoiser()
    model.load_state_dict(denoiser_state_dict_from_jax(params))
    rng = np.random.default_rng(23)
    S = 50
    acc = rng.normal(0, 0.3, (S, 3)).astype(np.float32)
    gyro = rng.normal(0, 0.1, (S, 3)).astype(np.float32)
    if n_valid is not None:
        acc[n_valid:] = 0
        gyro[n_valid:] = 0
    dts = np.full(S, 0.01, np.float32)
    init = (np.float32([1, 2, 3]), np.float32([0, 0, 0.6, 0.8]),
            np.float32([0.5, 0, 0]))
    ref = jax.jit(lambda *a: jdn.denoise_and_integrate(*a[:5], 9.81, a[5]))(
        params, jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
        JState(*map(jnp.asarray, init)),
        None if n_valid is None else jnp.asarray(n_valid))
    with torch.no_grad():
        out = dn.denoise_and_integrate(
            model, torch.from_numpy(acc), torch.from_numpy(gyro),
            torch.from_numpy(dts), IMUState(*map(torch.from_numpy, init)),
            9.81, None if n_valid is None else torch.tensor(n_valid))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
