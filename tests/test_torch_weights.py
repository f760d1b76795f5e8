"""PyTorch port: bundled npz weights read with numpy alone equal the JAX
package's ``load_params_npz`` leaves exactly, in PyTorch layouts."""

import numpy as np
import pytest
import jax

from twinvoice_tpu.models import pretrained as jax_pretrained
from twinvoice_tpu.train.checkpoint import load_params_npz
from twinvoice_tpu_torch.models import pretrained
from twinvoice_tpu_torch.weights import load_npz, parse_keystr, read_npz_tree

# JAX layout → torch layout, by the leaf's last key and its parent list
_HWIO_TO_OIHW = (3, 2, 0, 1)
_UP_TO_TORCH = (2, 3, 0, 1)


def _port_leaf(tree, path):
    node = tree
    for k in path[:-1]:
        node = node[k]
    leaf = path[-1]
    if leaf == "kernel":
        perm = _UP_TO_TORCH if path[0] == "up" else _HWIO_TO_OIHW
        return node["weight"].numpy(), perm
    return node[leaf].numpy(), None


@pytest.mark.parametrize("variant", sorted(pretrained.VARIANTS))
def test_bundled_weights_equal_jax_leaves(variant):
    path = pretrained.variant_path(variant)
    assert path == jax_pretrained.variant_path(variant)
    cfg = pretrained.VARIANTS[variant][1]
    jp, js = load_params_npz(path, jax_pretrained.VARIANTS[variant][1])
    tp, ts = load_npz(path)
    n = 0
    for jtree, ttree in ((jp, tp), (js, ts)):
        for kp, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            keys = parse_keystr(jax.tree_util.keystr(kp))
            got, perm = _port_leaf(ttree, keys)
            want = np.asarray(leaf)
            if perm is not None:
                want = np.transpose(want, perm)
            assert got.dtype == want.dtype == np.float32, keys
            np.testing.assert_array_equal(got, want, err_msg=str(keys))
            n += 1
    with np.load(path) as z:
        assert n == len(z.files)
    assert tp["enc"][0]["conv1"]["weight"].shape == (cfg.base_width, 3, 3, 3)
    assert tp["up"][0]["weight"].shape == (cfg.bottleneck_width(),
                                           cfg.encoder_widths()[-1], 2, 2)


def test_parse_keystr_and_tree_shape():
    assert parse_keystr("['enc'][0]['conv1']['kernel']") == ["enc", 0, "conv1", "kernel"]
    with pytest.raises(ValueError):
        parse_keystr("enc.0.conv1")
    params, state = read_npz_tree(pretrained.variant_path("w16"))
    assert len(params["enc"]) == len(params["dec"]) == len(params["up"]) == 4
    assert params["enc"][0]["conv1"]["kernel"].shape == (3, 3, 3, 16)
    assert set(state["bottleneck"]) == {"bn1", "bn2"}
