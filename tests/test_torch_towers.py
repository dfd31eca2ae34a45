"""Port parity for the other vision towers: the name-sniffing builder,
CLIP, S², InternViT (on K1's D = 128 form) and RADIO.

Weights come from the JAX package's ``init_params`` trees through the
port's ``load_*_from_jax`` (the HF / timm names of each converter), inputs
from numpy seeds; each port function runs in fp32 on the CPU, where K1's
wrapper takes its plain version, beside its JAX function (whose towers
take XLA attention off the TPU).  K1's plain version is held to the Pallas
kernel in interpret mode at InternViT's head dim.  Tolerance: atol 2e-5 /
rtol 2e-4 (fp32 summation order) unless a test states its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.models import clip as jclip
from spatialrgpt_tpu.models import intern_vit as jintern
from spatialrgpt_tpu.models import radio as jradio
from spatialrgpt_tpu.models import s2 as js2
from spatialrgpt_tpu.models import tower_builder as jtb
from spatialrgpt_tpu.ops.vit_attention import vit_attention as j_vit
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.models import clip as tclip
from spatialrgpt_tpu_torch.models import intern_vit as tintern
from spatialrgpt_tpu_torch.models import radio as tradio
from spatialrgpt_tpu_torch.models import s2 as ts2
from spatialrgpt_tpu_torch.models import tower_builder as ttb
from spatialrgpt_tpu_torch.ops import vit_attention as K1
from spatialrgpt_tpu_torch.utils.weights import (
    export_intern_vit,
    export_radio,
    init_random_clip,
    init_random_intern_vit,
    init_random_radio,
    load_clip_from_jax,
    load_intern_vit_from_jax,
    load_radio_from_jax,
)

ATOL, RTOL = 2e-5, 2e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pixels(seed, n, size):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

TOWER_NAMES = ["google/siglip-so400m-patch14-384", "openai/clip-vit-large-patch14-336",
               "OpenGVLab/InternViT-6B-448px-V1-5", "radio:768:radio_v2.5-h:skip_layer_norm=True,x", "nvidia/RADIO"]


def _as_dict(handle):
    d = dataclasses.asdict(handle)
    return {k: v for k, v in d.items() if k != "config"}, dataclasses.asdict(handle.config)


@pytest.mark.parametrize("use_s2", [False, True])
@pytest.mark.parametrize("name", TOWER_NAMES)
def test_build_vision_tower_equals_reference(name, use_s2):
    """The family, the config's fields, the S² scales and mm_hidden_size
    equal the reference's for the same arguments (CLIP-S² at 3 x 1024)."""
    kw = dict(use_s2=use_s2, s2_scales="336,672,1008", select_layer=-3, select_feature="cls_patch")
    want, got = jtb.build_vision_tower(name, **kw), ttb.build_vision_tower(name, **kw)
    assert type(got.config).__name__ == type(want.config).__name__
    assert _as_dict(got) == _as_dict(want)
    if "clip" in name and use_s2:
        assert got.mm_hidden_size == 3 * 1024 and got.s2_scales == (336, 672, 1008)


# ---------------------------------------------------------------------------
# CLIP and S²
# ---------------------------------------------------------------------------


def _clip_cfgs(**kw):
    c = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4, image_size=56,
             patch_size=14, select_layer=-2, select_feature="patch")
    c.update(kw)
    return jconfig.SiglipVisionConfig(**c), tconfig.SiglipVisionConfig(**c)


@pytest.fixture(scope="module")
def clip_pair():
    jcfg, tcfg = _clip_cfgs()
    params = jclip.init_params(jax.random.PRNGKey(3), jcfg)
    return params, load_clip_from_jax(_np_tree(params), tcfg, "cpu")


@pytest.mark.parametrize("select_layer,select_feature", [(-2, "patch"), (-1, "cls_patch"), (1, "patch")])
def test_clip_forward_features(clip_pair, select_layer, select_feature):
    """3 layers, 64 wide, 4 heads, 56 px: quick-GELU, the pre-LN, the class
    token, ``select_layer`` and ``select_feature`` as the reference's; the
    K1 route and the plain route agree on the CPU."""
    params, model = clip_pair
    jcfg, tcfg = _clip_cfgs(select_layer=select_layer, select_feature=select_feature)
    px = _pixels(1, 2, 56)
    want = jclip.forward_features(params, jnp.asarray(px), jcfg)
    got = tclip.forward_features(model, torch.tensor(px), tcfg)
    assert tuple(got.shape) == want.shape == (2, 16 + (select_feature == "cls_patch"), 64)
    _close(got, want)
    torch.testing.assert_close(tclip.forward_features(model, torch.tensor(px), tcfg, "xla"), got, rtol=0, atol=0)


def test_convert_clip_reads_the_hf_names(clip_pair):
    """An HF ``CLIPVisionModel`` state dict (bare names, HF's position_ids
    and a deeper layer that is left out) through both converters."""
    params, _ = clip_pair
    jcfg, tcfg = _clip_cfgs()
    from spatialrgpt_tpu_torch.utils.weights import export_clip

    sd = {k[len("vision_model."):]: torch.tensor(v) for k, v in export_clip(_np_tree(params)).items()}
    sd["embeddings.position_ids"] = torch.arange(17)[None]
    sd["encoder.layers.3.mlp.fc1.weight"] = torch.zeros(128, 64)
    jp = jclip.convert_clip(sd, 3)
    state = tclip.convert_clip(sd, 3)
    model = tclip.ClipVisionModel(tcfg)
    model.load_state_dict(state, strict=True)
    px = _pixels(2, 1, 56)
    _close(tclip.forward_features(model, torch.tensor(px), tcfg), jclip.forward_features(jp, jnp.asarray(px), jcfg))


def test_s2_crop_order_equals_reference():
    """_split_crops / _merge_crops: raster-order crops, and the merge
    inverts the split, exactly as the reference's."""
    x = np.arange(2 * 6 * 6 * 3, dtype=np.float32).reshape(2, 6, 6, 3)
    for n in (2, 3):
        want = js2._split_crops(jnp.asarray(x), n)
        got = ts2._split_crops(torch.tensor(x), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ts2._merge_crops(got, n).numpy(), x)
        np.testing.assert_array_equal(ts2._merge_crops(got, n).numpy(), np.asarray(js2._merge_crops(want, n)))


@pytest.mark.parametrize("scales", [(56, 112), (56, 112, 168)])
def test_s2_multiscale_forward_over_clip(clip_pair, scales):
    """S² over the CLIP tower at base 56: every scale's crops in one tower
    call (one call counted here), JAX's bilinear resize without antialias
    from the largest scale, the crops merged and pooled to the base grid,
    the scales concatenated in order."""
    params, model = clip_pair
    jcfg, tcfg = _clip_cfgs()
    px = _pixels(4, 2, scales[-1])
    calls = []

    def tower(x):
        calls.append(x.shape[0])
        return tclip.forward_features(model, x, tcfg)

    want = js2.multiscale_forward(lambda x: jclip.forward_features(params, x, jcfg), jnp.asarray(px), scales, 56)
    got = ts2.multiscale_forward(tower, torch.tensor(px), scales, 56)
    assert calls == [2 * sum((s // 56) ** 2 for s in scales)]
    assert tuple(got.shape) == want.shape == (2, 16, 64 * len(scales))
    _close(got, want, atol=5e-5)


# ---------------------------------------------------------------------------
# K1 at InternViT's head dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid_len", [None, 50])
def test_vit_plain_matches_pallas_at_d128(valid_len):
    """K1's plain version against the Pallas kernel in interpret mode at
    D = 128 with H = 5 (odd, as InternViT-6B's 25) and a ragged S = 65."""
    rng = np.random.default_rng(65)
    q, k, v = (rng.standard_normal((2, 65, 5, 128)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_vit(*map(jnp.asarray, (q, k, v)), interpret=True, valid_len=valid_len))
    got = K1.vit_attention_plain(*map(torch.tensor, (q, k, v)), valid_len=valid_len)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)


# ---------------------------------------------------------------------------
# InternViT
# ---------------------------------------------------------------------------


def _intern_cfgs(**kw):
    c = dict(hidden_size=256, intermediate_size=384, num_hidden_layers=2, num_attention_heads=2, image_size=42,
             patch_size=14)
    c.update(kw)
    return jintern.InternVisionConfig(**c), tintern.InternVisionConfig(**c)


def _intern_params(jcfg, seed=5):
    """``init_params`` with its unit norms and layer scales and zero biases
    redrawn, so that every weight counts."""
    params = _np_tree(jintern.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "bias" in name or "norm" in name or "'ls" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape) if "bias" not in name
                    else 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


@pytest.mark.parametrize("select_layer,select_feature", [(-1, "patch"), (1, "cls_patch")])
@pytest.mark.parametrize("qk_norm", [True, False])
def test_intern_vit_forward_features(qk_norm, select_layer, select_feature):
    """D = 128, 2 heads, 2 layers at 42 px (10 tokens): the patch bias, the
    class token, RMSNorm pre-norms, the q/k RMSNorm over the flattened H*D
    axis (with and without), the layer scales, exact GELU and
    ``select_layer``; weights through the converter's fused-qkv path."""
    jcfg, tcfg = _intern_cfgs(qk_normalization=qk_norm, select_layer=select_layer, select_feature=select_feature)
    params = _intern_params(jcfg)
    model = load_intern_vit_from_jax(params, tcfg, "cpu")
    px = _pixels(6, 2, 42)
    want = jintern.forward_features(params, jnp.asarray(px), jcfg)
    got = tintern.forward_features(model, torch.tensor(px), tcfg)
    assert tuple(got.shape) == want.shape == (2, 9 + (select_feature == "cls_patch"), 256)
    _close(got, want, atol=5e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_convert_intern_vit_split_qkv(bias):
    """An HF ``InternVLVisionModel`` state dict with separate q/k/v
    projections, with and without biases (``attention_bias=False``): the
    reference's converter and the port's give the same tower."""
    jcfg, tcfg = _intern_cfgs()
    params = _intern_params(jcfg, seed=7)
    fused = export_intern_vit(params)
    sd = {}
    for name, a in fused.items():
        if ".attention.qkv." in name:
            for j, n in enumerate("qkv"):
                sd[name.replace(".qkv.", f".{n}_proj.")] = a[j * 256 : (j + 1) * 256]
        else:
            sd[name] = a
    if not bias:
        sd = {k: v for k, v in sd.items() if not (k.endswith(".bias") and ".attention." in k)}
    sd = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
    jp = jintern.convert_intern_vit(sd, jcfg)
    assert ("bias" in jp["layers"][0]["qkv"]) == bias
    model = tintern.InternVisionModel(tcfg)
    model.load_state_dict(tintern.convert_intern_vit(sd, tcfg), strict=True)
    px = _pixels(8, 1, 42)
    _close(tintern.forward_features(model, torch.tensor(px), tcfg), jintern.forward_features(jp, jnp.asarray(px), jcfg),
           atol=5e-5)


# ---------------------------------------------------------------------------
# RADIO
# ---------------------------------------------------------------------------

RADIO_CFG = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4, intermediate_size=64, patch_size=16,
                 num_cls_tokens=4, cpe_grid=8)


@pytest.fixture(scope="module")
def radio_pair():
    jcfg, tcfg = jradio.RadioBackboneConfig(**RADIO_CFG), tradio.RadioBackboneConfig(**RADIO_CFG)
    params = _np_tree(jradio.init_radio_params(jax.random.PRNGKey(9), jcfg))
    return jcfg, tcfg, params, load_radio_from_jax(params, tcfg, "cpu")


@pytest.mark.parametrize("select_feature,hidden", [("patch", 32), ("dense", 128), ("cls", 128), ("cls4", 32)])
def test_radio_tower_selects(radio_pair, select_feature, hidden):
    """``RadioVisionTower`` on a non-square 48 x 80 input (a 3 x 5 patch
    grid: the CPE table resampled) in each feature select, and its
    ``hidden_size``, against the reference's tower on the same weights."""
    jcfg, tcfg, params, model = radio_pair
    px = _pixels(10, 2, 80)[:, :48]
    want_tower = jradio.RadioVisionTower("radio:64:radio_v2:", params=params, backbone_cfg=jcfg,
                                         select_feature=select_feature)
    got_tower = tradio.RadioVisionTower("radio:64:radio_v2:", model=model, backbone_cfg=tcfg,
                                        select_feature=select_feature)
    assert got_tower.hidden_size == want_tower.hidden_size == hidden
    want, got = want_tower(jnp.asarray(px)), got_tower(torch.tensor(px))
    assert tuple(got.shape) == want.shape
    assert got.shape[-1] == hidden or select_feature == "cls"
    _close(got, want, atol=5e-5)


def test_radio_forward_and_dense_outputs(radio_pair):
    """``radio_forward`` (summary, features) and ``radio_forward_dense``'s
    quarter-depth averages at the CPE table's own grid (no resample) and
    with ``skip_layer_norm``."""
    jcfg, tcfg, params, model = radio_pair
    px = _pixels(11, 1, 128)
    for skip in (False, True):
        jc, tc = dataclasses.replace(jcfg, skip_layer_norm=skip), dataclasses.replace(tcfg, skip_layer_norm=skip)
        for jf, tf in ((jradio.radio_forward, tradio.radio_forward), (jradio.radio_forward_dense,
                                                                         tradio.radio_forward_dense)):
            (js, jfeat), (ts, tfeat) = jf(params, jc, jnp.asarray(px)), tf(model, tc, torch.tensor(px))
            _close(ts, js, atol=5e-5)
            _close(tfeat, jfeat, atol=5e-5)


@pytest.mark.parametrize("gh,gw", [(3, 5), (12, 6), (8, 11), (8, 8)])
def test_radio_cpe_resize(gh, gw):
    """The CPE table (an 8 x 8 grid) resampled to non-square grids, down,
    up and mixed, as ``jax.image.resize(..., "bilinear")`` resamples it."""
    table = np.random.default_rng(gh * 100 + gw).standard_normal((64, 16)).astype(np.float32)
    want = jradio.cpe_position_embed(jnp.asarray(table), 8, gh, gw)
    got = tradio.cpe_position_embed(torch.tensor(table), 8, gh, gw)
    _close(got, want, atol=1e-6, rtol=1e-5)


def test_radio_spec_and_processor_equal_reference():
    """The copied spec parser and processor give the reference's fields and
    arrays (PIL's bicubic longest-edge resize, round-half-up, the
    bottom/right pad) for a numpy and a PIL image."""
    for spec in ("radio:432:radio_v2.1:", "radio:768:radio_v2.5-h:skip_layer_norm=True,foo"):
        assert dataclasses.astuple(tradio.parse_radio_spec(spec)) == dataclasses.astuple(jradio.parse_radio_spec(spec))
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (37, 61, 3), dtype=np.uint8)
    for image in (img, Image.fromarray(img)):
        want, got = jradio.RadioImageProcessor(longest_edge=96)(image), tradio.RadioImageProcessor(longest_edge=96)(image)
        assert got["unpadded_size"] == want["unpadded_size"]
        np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
        assert got["pixel_values"].shape == (64, 96, 3)


@pytest.mark.parametrize("conv", [True, False])
def test_convert_radio_state_dict_timm_layout(conv):
    """A state dict in the released checkpoints' timm layout, built in
    numpy (the embedder as a (H, 3, P, P) conv or a (H, 3 P P) linear
    without a bias, the summary tokens as (1, 4, H)), through both
    converters: the same features; a misshapen entry raises."""
    cfg = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32, patch_size=4,
               num_cls_tokens=4, cpe_grid=4)
    jcfg, tcfg = jradio.RadioBackboneConfig(**cfg), tradio.RadioBackboneConfig(**cfg)
    rng = np.random.default_rng(13)
    H, I, P = 16, 32, 4
    emb = rng.standard_normal((H, 3, P, P)).astype(np.float32)
    sd = {
        "model.patch_generator.embedder.weight": emb if conv else emb.reshape(H, -1),
        "model.patch_generator.cls_token.token": rng.standard_normal((1, 4, H)).astype(np.float32),
        "model.patch_generator.pos_embed": rng.standard_normal((1, 16, H)).astype(np.float32),
        "model.norm.weight": 1 + 0.1 * rng.standard_normal(H).astype(np.float32),
        "model.norm.bias": 0.1 * rng.standard_normal(H).astype(np.float32),
    }
    for i in range(2):
        pre = f"model.blocks.{i}"
        for name, shape in (("norm1", (H,)), ("norm2", (H,)), ("attn.qkv", (3 * H, H)), ("attn.proj", (H, H)),
                            ("mlp.fc1", (I, H)), ("mlp.fc2", (H, I))):
            sd[f"{pre}.{name}.weight"] = (0.3 * rng.standard_normal(shape)).astype(np.float32)
            sd[f"{pre}.{name}.bias"] = (0.1 * rng.standard_normal(shape[0])).astype(np.float32)
    jp = jradio.convert_radio_state_dict(sd, jcfg)
    model = tradio.RadioModel(tcfg)
    model.load_state_dict(tradio.convert_radio_state_dict(sd, tcfg), strict=True)
    px = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    (js, jf), (ts, tf) = jradio.radio_forward(jp, jcfg, jnp.asarray(px)), tradio.radio_forward(model, tcfg, torch.tensor(px))
    _close(tf, jf, atol=5e-5)
    _close(ts, js, atol=5e-5)
    bad = dict(sd, **{"model.blocks.1.mlp.fc1.weight": np.zeros((I + 1, H), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tradio.convert_radio_state_dict(bad, tcfg)


def test_export_radio_inverts_the_converter(radio_pair):
    """``export_radio`` writes the timm names that the JAX converter reads
    back into the same tree."""
    jcfg, _, params, _ = radio_pair
    back = jradio.convert_radio_state_dict(export_radio(params), jcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# random weights and the entry points' device
# ---------------------------------------------------------------------------


def test_init_random_towers_follow_the_recipe():
    """``init_random_{clip,intern_vit,radio}`` on the CPU at small widths:
    the JAX recipe's scales (N(0, 0.02) tables, N(0, fan_in^-1/2) dense
    kernels, unit norms and layer scales, zero biases), from a seed."""
    _, ccfg = _clip_cfgs()
    clip = init_random_clip(ccfg, "cpu", torch.float32, seed=1)
    assert abs(float(clip.vision_model.embeddings.class_embedding.std()) - 0.02) < 0.01
    fc1 = clip.vision_model.encoder.layers[0].mlp.fc1
    assert abs(float(fc1.weight.std()) * 64**0.5 - 1) < 0.1 and not fc1.bias.any()
    _, icfg = _intern_cfgs()
    intern = init_random_intern_vit(icfg, "cpu", torch.float32, seed=1)
    layer = intern.encoder.layer[1]
    assert bool((layer.lambda_1 == 1).all() and (layer.attention.q_norm.weight == 1).all())
    assert abs(float(intern.embeddings.position_embeddings.std()) - 0.02) < 0.005
    rcfg = tradio.RadioBackboneConfig(**RADIO_CFG)
    radio = init_random_radio(rcfg, "cpu", torch.float32, seed=1)
    emb = radio.model.patch_generator.embedder.weight
    assert abs(float(emb.std()) * (3 * 16 * 16) ** 0.5 - 1) < 0.1
    again = init_random_radio(rcfg, "cpu", torch.float32, seed=1)
    assert all(torch.equal(a, b) for a, b in zip(radio.state_dict().values(), again.state_dict().values()))


def test_radio_tower_defaults_to_the_card():
    """Without a model the tower makes its backbone on the card; without
    one it raises unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tradio.RadioVisionTower("radio:64:radio_v2:", backbone_cfg=tradio.RadioBackboneConfig(**RADIO_CFG))
    t = tradio.RadioVisionTower("radio:64:radio_v2:", backbone_cfg=tradio.RadioBackboneConfig(**RADIO_CFG),
                                device="cpu")
    assert tuple(t(torch.zeros(1, 32, 32, 3)).shape) == (1, 4, 32)
