"""Shared inputs for the PyTorch port's tests (``tests/test_torch_*.py``)."""

import numpy as np

from twinvoice_tpu.config import UNetConfig as JaxUNetConfig
from twinvoice_tpu_torch.ops import qconv


def random_unet(seed, base_width=8, depth=4):
    """Random U-Net ``(params, state)`` numpy trees with the structure of
    ``twinvoice_tpu.models.unet.init_unet`` (built in numpy: an eager JAX
    init costs tens of seconds on the CPU). Conv weights follow torch's
    default init bounds; BN statistics are random so folding is not the
    identity; the out bias is mixed so some fields are found and some not.
    → (JAX UNetConfig, params, state)."""
    cfg = JaxUNetConfig(base_width=base_width, depth=depth)
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    def conv(k, ci, co):
        bound = 1.0 / np.sqrt(k * k * ci)
        return {"kernel": f32(rng.uniform(-bound, bound, (k, k, ci, co))),
                "bias": f32(rng.uniform(-bound, bound, co))}

    def double_conv(ci, co):
        params, state = {}, {}
        for i, c_in in ((1, ci), (2, co)):
            params[f"conv{i}"] = conv(3, c_in, co)
            params[f"bn{i}"] = {"scale": f32(rng.uniform(0.5, 1.5, co)),
                                "bias": f32(0.1 * rng.standard_normal(co))}
            state[f"bn{i}"] = {"mean": f32(0.1 * rng.standard_normal(co)),
                               "var": f32(rng.uniform(0.5, 1.5, co))}
        return params, state

    widths = cfg.encoder_widths()
    params = {"enc": [], "up": [], "dec": []}
    state = {"enc": [], "dec": []}
    cin = cfg.in_channels
    for w in widths:
        p, s = double_conv(cin, w)
        params["enc"].append(p)
        state["enc"].append(s)
        cin = w
    params["bottleneck"], state["bottleneck"] = double_conv(cin, cfg.bottleneck_width())
    up_in = cfg.bottleneck_width()
    for w in reversed(widths):
        bound = 1.0 / np.sqrt(4 * w)
        params["up"].append({"kernel": f32(rng.uniform(-bound, bound, (2, 2, up_in, w))),
                             "bias": f32(rng.uniform(-bound, bound, w))})
        p, s = double_conv(2 * w, w)
        params["dec"].append(p)
        state["dec"].append(s)
        up_in = w
    params["out"] = conv(1, widths[0], cfg.num_classes)
    params["out"]["bias"] = f32([0.5, -0.8, 0.0])
    return cfg, params, state


def int8_unet(seed=3, grid=32):
    """A random base-width-8 U-Net quantized by the JAX package on two
    calibration batches of ``grid``² pages, and the same qparams carried into
    the port. → {"jcfg", "params", "state", "tp", "ts", "calib", "jq", "q"}."""
    import jax
    import jax.numpy as jnp

    from twinvoice_tpu.infer import quant as jquant
    from twinvoice_tpu.models.unet import fold_unet as jax_fold_unet
    from twinvoice_tpu_torch.weights import from_jax_params, from_jax_qparams

    from tests.test_torch_pipeline import pages

    jcfg, params, state = random_unet(seed)
    jfolded = jax_fold_unet(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, state), cfg=jcfg)
    tp, ts = from_jax_params(params, state)
    calib = [pages(5, 2, grid, grid), pages(6, 1, grid, grid)]
    jq = jquant.quantize_unet(jfolded, calib)
    return {"jcfg": jcfg, "params": params, "state": state, "tp": tp, "ts": ts,
            "calib": calib, "jq": jq, "q": from_jax_qparams(jq)}


# -- requant ties between a fused and an unfused float32 epilogue -----------------


def fma_f32(x, y, z):
    """numpy float32 ``x·y + z`` rounded once: the port's ``ops.qconv.fma32``
    (held to exact rationals in ``tests/test_torch_epilogue.py``) on numpy
    values."""
    return qconv.fma32(*(np.asarray(t, np.float32) for t in (x, y, z))).numpy()


def requant_np(y, inv, relu):
    """``quant._requant`` (and its symmetric form) on float32 numpy values."""
    y = np.asarray(y, np.float32)
    if relu:
        y = np.maximum(y, np.float32(0))
    q = np.round((y * np.float32(inv)).astype(np.float32))
    return np.clip(q, 0 if relu else -127, 127).astype(np.int8)


def tie_bias(forms, b0, inv, relu, steps=4096):
    """The float32 bias nearest ``b0`` (in steps of one float32 ulp) at which
    the epilogues ``forms`` (each ``bias array → float32 y``) requantise
    apart, or None. ``b0`` is chosen by the caller so that ``y`` sits near a
    rounding boundary of the requant."""
    bits = np.float32(b0).view(np.int32).astype(np.int64)
    order = np.argsort(np.abs(np.arange(-steps, steps)), kind="stable") - steps
    cand = (bits + order).astype(np.int32).view(np.float32)
    qs = [requant_np(f(cand), inv, relu) for f in forms]
    apart = np.zeros(cand.shape, bool)
    for q in qs[1:]:
        apart |= q != qs[0]
    idx = np.flatnonzero(apart)
    return None if idx.size == 0 else np.float32(cand[idx[0]])


def tie_biases(forms_at, mag, inv, relu, target):
    """One float32 bias per output channel (the last axis of ``mag``), each on
    a requant tie: ``forms_at(c, idx)`` gives channel ``c``'s epilogues (bias
    → y) at output ``idx``; the search (:func:`tie_bias`) starts where the
    first form puts ``y`` on the boundary ``target + 0.5``, at the channel's
    largest ``mag`` (or the next largest, where a product happens to round
    too little to split the forms)."""
    bias = np.zeros(mag.shape[-1], np.float32)
    y0 = np.float32((target + 0.5) / np.float32(inv))
    for c in range(mag.shape[-1]):
        m = mag[..., c]
        for flat in np.argsort(-m, axis=None, kind="stable")[:32]:
            forms = forms_at(c, np.unravel_index(flat, m.shape))
            b = tie_bias(forms, y0 - forms[0](np.float32(0)), inv, relu)
            if b is not None:
                bias[c] = b
                break
        else:
            raise AssertionError(f"no tie found for channel {c}")
    return bias


def product_tie_biases(acc, a, inv, relu):
    """:func:`tie_biases` for the product epilogue: ``fma(acc, a, b)``
    against the unfused ``acc·a + b``, ``acc`` (…, Co) float32 sums."""
    def forms_at(c, idx):
        v = np.float32(acc[idx + (c,)])
        return [lambda b: fma_f32(v, a[c], b),
                lambda b: (np.float32(v * a[c]) + b).astype(np.float32)]

    return tie_biases(forms_at, np.abs(acc), inv, relu, 60 if relu else -21)


# -- a float64 train step: the exact value both float32 trainers approximate --------


def float64_step(params, state, images, masks, *, momentum=0.1, eps=1e-5, dice_w=0.85,
                 focal_w=0.15, alpha=0.8, gamma=2.0, smooth=1.0, focal_eps=1e-7):
    """One train-mode forward and backward of the U-Net in float64, written
    from the formulas with ``torch.nn.functional`` (two-pass batch variance,
    torch's ``BatchNorm2d`` running-statistics rule), independent of the
    port's modules and of the JAX package. ``params``/``state`` are numpy
    trees in the JAX layout, ``images``/``masks`` NHWC numpy.
    → (loss, {keystr: gradient in the JAX layout}, {keystr: new BN state})."""
    import torch
    import torch.nn.functional as F

    from twinvoice_tpu_torch.weights import keystr_items

    def t64(a, perm=None):
        a = np.asarray(a, np.float64)
        return torch.from_numpy(np.ascontiguousarray(
            a if perm is None else np.transpose(a, perm))).requires_grad_()

    grads_of, leaves = {}, {}
    for key, leaf in keystr_items(params):
        perm = None
        if key.endswith("['kernel']"):
            perm = (2, 3, 0, 1) if key.startswith("['up']") else (3, 2, 0, 1)
        leaves[key] = t64(leaf, perm)
        grads_of[key] = perm
    new_state = {}

    def bn(x, key, skey):
        mean = x.mean((0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
        n = x.shape[0] * x.shape[2] * x.shape[3]
        s = {k: np.asarray(v, np.float64) for k, v in dict(keystr_items(state)).items()}
        new_state[skey + "['mean']"] = (1 - momentum) * s[skey + "['mean']"] + \
            momentum * mean.detach().numpy()
        new_state[skey + "['var']"] = (1 - momentum) * s[skey + "['var']"] + \
            momentum * var.detach().numpy() * n / (n - 1)
        return ((x - mean[:, None, None]) / torch.sqrt(var + eps)[:, None, None]
                * leaves[key + "['scale']"][:, None, None] + leaves[key + "['bias']"][:, None, None])

    def dc(prefix, x):
        for i in (1, 2):
            x = F.conv2d(x, leaves[f"{prefix}['conv{i}']['kernel']"],
                         leaves[f"{prefix}['conv{i}']['bias']"], padding=1)
            x = torch.relu(bn(x, f"{prefix}['bn{i}']", f"{prefix}['bn{i}']"))
        return x

    x = torch.from_numpy(np.asarray(images, np.float64)).permute(0, 3, 1, 2)
    depth = len(params["enc"])
    skips = []
    for i in range(depth):
        x = dc(f"['enc'][{i}]", x)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = dc("['bottleneck']", x)
    for i in range(depth):
        x = F.conv_transpose2d(x, leaves[f"['up'][{i}]['kernel']"],
                               leaves[f"['up'][{i}]['bias']"], stride=2)
        x = dc(f"['dec'][{i}]", torch.cat([x, skips[depth - 1 - i]], dim=1))
    logits = F.conv2d(x, leaves["['out']['kernel']"], leaves["['out']['bias']"])
    p = torch.sigmoid(logits)
    t = torch.from_numpy(np.asarray(masks, np.float64)).permute(0, 3, 1, 2)
    inter = (p * t).sum((2, 3))
    union = p.sum((2, 3)) + t.sum((2, 3))
    dice = (1 - (2 * inter + smooth) / (union + smooth)).mean()
    pc = p.clamp(focal_eps, 1 - focal_eps)
    bce = -(t * torch.log(pc) + (1 - t) * torch.log(1 - pc))
    focal = (alpha * (1 - torch.exp(-bce)) ** gamma * bce).mean()
    loss = dice_w * dice + focal_w * focal
    loss.backward()
    grads = {}
    for key, perm in grads_of.items():
        g = leaves[key].grad.numpy()
        grads[key] = g if perm is None else np.transpose(g, np.argsort(perm))
    return float(loss.detach()), grads, new_state

