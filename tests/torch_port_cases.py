"""Shared inputs for the PyTorch port's tests (``tests/test_torch_*.py``)."""

import numpy as np

from twinvoice_tpu.config import UNetConfig as JaxUNetConfig


def random_unet(seed, base_width=8):
    """Random U-Net ``(params, state)`` numpy trees with the structure of
    ``twinvoice_tpu.models.unet.init_unet`` (built in numpy: an eager JAX
    init costs tens of seconds on the CPU). Conv weights follow torch's
    default init bounds; BN statistics are random so folding is not the
    identity; the out bias is mixed so some fields are found and some not.
    → (JAX UNetConfig, params, state)."""
    cfg = JaxUNetConfig(base_width=base_width)
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
