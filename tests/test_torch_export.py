"""The port's serving export (`kgtpu_torch/export.py`) against kgtpu's
(`kgtpu/export.py`): kgtpu's four round-trip cases (`tests/test_export.py`),
the same tiny checkpoint exported by both packages and served on the same
seeded uint8 images in all three modes, the CLI's manifest, and the exported
graph's GroupNorm nodes.

The checkpoint is kgtpu's tiny random init with the heatmap head's output
bias raised from the focal prior (-2.19) to +1, so that the grouper finds
detections and the mask stage and paste run; it goes to the port through
`tools/orbax_to_torch.convert`.  Tolerances: integer outputs (label maps,
valid) exact; floats 1e-4 abs+rel, kgtpu's own tolerance for its artifact
against its live path.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from kgtpu import checkpoint as jckpt
from kgtpu import train_lib as jtrain
from kgtpu.config import tiny_test_config as jtiny
from kgtpu.export import export_infer as jexport_infer
from kgtpu.export import load_serving as jload_serving
from kgtpu_torch import checkpoint as tckpt
from kgtpu_torch.config import Config
from kgtpu_torch.export import _main as export_main
from kgtpu_torch.export import export_infer, load_serving
from kgtpu_torch.infer import build_infer_fn
from kgtpu_torch.models import KGNet
from kgtpu_torch.models.blocks import GroupNorm
from tools.orbax_to_torch import convert

TOL = dict(rtol=1e-4, atol=1e-4)
OP = torch.ops.kgtpu_torch.group_norm_relu.default


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(manifest, seed):
    rng = np.random.default_rng(seed)
    spec = manifest["inputs"]
    if isinstance(spec, dict):
        return {k: rng.integers(0, 256, v, np.uint8) for k, v in spec.items()}
    return rng.integers(0, 256, spec, np.uint8)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny checkpoint in both formats; both packages' artifacts in the
    three modes (the port's single one through its CLI) and their outputs on
    the same images.  kgtpu's results are awaited before torch computes."""
    root = tmp_path_factory.mktemp("export")
    cfg = jtiny()
    state = jtrain.create_train_state(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    params["heads_0"]["hm_out"]["bias"] = np.ones_like(params["heads_0"]["hm_out"]["bias"])
    state = state.replace(params=params)
    jw, tw = str(root / "w_jax"), str(root / "w_torch")
    jckpt.save(jw, epoch=0, state=state, extra={"config_json": jckpt.encode_config(cfg)})
    convert(jw, tw)
    modes = {
        "single": dict(batch=2, input_size=128),
        "tta": dict(batch=1, input_size=128, mode="tta", test_scales=(0.75, 1.0)),
        "tiled": dict(mode="tiled", slide_hw=(192, 192), input_size=128, tile_size=128),
    }
    out = {"root": root, "tw": tw, "jax": {}, "torch": {}}
    for mode, kw in modes.items():
        art = str(root / f"{mode}.kgx")
        m = jexport_infer(jw, art, platforms=("cpu",), **kw)
        images = _inputs(m, seed=len(mode))
        got = jax.block_until_ready(jload_serving(art)(images))
        out["jax"][mode] = (m, images, {k: np.asarray(v) for k, v in got.items()})
    for mode, kw in modes.items():
        art = str(root / f"{mode}.pt2")
        m = export_infer(tw, art, platforms=("cpu",), **kw)
        out["torch"][mode] = (m, art)
    return out


def test_export_roundtrip_matches_live_infer(exported):
    """kgtpu's first case: the artifact's outputs equal the live
    `build_infer_fn` on the checkpoint (same config derivation: stored
    architecture, default inference knobs, the canvas override)."""
    manifest, art = exported["torch"]["single"]
    assert os.path.getsize(art) == manifest["bytes"] > 0
    assert manifest["input_size"] == 128 and "label_map" in manifest["outputs"]
    _, images, _ = exported["jax"]["single"]
    got = load_serving(art, device="cpu")(images)
    state_dict, extra = tckpt.restore_bundle(exported["tw"])
    stored = tckpt.decode_config(extra)
    cfg = dataclasses.replace(Config(), model=stored.model,
                              infer=dataclasses.replace(Config().infer, input_size=128))
    model = KGNet(cfg.model)
    model.load_state_dict(state_dict)
    want = build_infer_fn(model, cfg, device="cpu")(images)
    assert set(got) == set(want) and int(want["valid"].sum()) > 0
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_export_rejects_bad_canvas(exported, tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        export_infer(exported["tw"], str(tmp_path / "x.pt2"), batch=1, input_size=100,
                     platforms=("cpu",))
    assert not os.path.exists(tmp_path / "x.pt2")


def test_export_tta_mode(exported):
    m, art = exported["torch"]["tta"]
    sides = {k: v[1] for k, v in m["inputs"].items()}
    assert sides["1"] == 128 and sides["0.75"] == 96       # round-to-divisor
    rng = np.random.default_rng(1)
    out = load_serving(art, device="cpu")(
        {k: rng.integers(0, 256, (1, s, s, 3), np.uint8) for k, s in sides.items()})
    assert tuple(out["label_map"].shape) == (1, 128, 128)


def test_export_tiled_mode(exported):
    m, art = exported["torch"]["tiled"]
    assert m["inputs"] == [192, 192, 3]
    rng = np.random.default_rng(2)
    out = load_serving(art, device="cpu")(rng.integers(0, 256, (192, 192, 3), np.uint8))
    assert tuple(out["label_map"].shape) == (192, 192)


@pytest.mark.parametrize("mode", ["single", "tta", "tiled"])
def test_artifacts_of_both_packages_agree(exported, mode):
    """The same checkpoint exported by kgtpu and by the port: each artifact's
    outputs on the same seeded uint8 images, with detections in every mode;
    the manifests carry the same keys, shapes and outputs."""
    jm, images, want = exported["jax"][mode]
    tm, art = exported["torch"][mode]
    assert set(tm) == set(jm)
    for key in ("mode", "batch", "input_size", "inputs", "outputs"):
        assert tm[key] == jm[key], key
    got = {k: v.numpy() for k, v in load_serving(art, device="cpu")(images).items()}
    assert set(got) == set(want) and int(want["valid"].sum()) > 0
    for k, w in want.items():
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_cli_writes_artifact_and_manifest(exported, capsys):
    """`python -m kgtpu_torch.export` with kgtpu's flags prints the manifest
    with kgtpu's keys; the artifact serves the exported shape."""
    art = str(exported["root"] / "cli.pt2")
    export_main(["--weights", exported["tw"], "--out", art, "--batch", "1",
                 "--input_size", "64", "--platforms", "cpu"])
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(m) == {"out", "bytes", "mode", "batch", "input_size", "inputs", "platforms",
                      "outputs"}
    assert (m["out"], m["bytes"], m["mode"], m["inputs"], m["platforms"]) == (
        art, os.path.getsize(art), "single", [1, 64, 64, 3], ["cpu"])
    serve = load_serving(art, device="cpu")
    assert serve.manifest["inputs"] == [1, 64, 64, 3]
    out = serve(np.zeros((1, 64, 64, 3), np.uint8))
    assert tuple(out["label_map"].shape) == (1, 64, 64)


def _op_nodes(gm) -> tuple[int, int]:
    ops = natives = 0
    for node in gm.graph.nodes:
        if node.op == "call_function":
            ops += node.target == OP
            natives += "native_group_norm" in str(node.target)
    return ops, natives


def test_graph_holds_the_groupnorm_op_once_per_norm(exported):
    """The single artifact: the backbone's and heads' eval-mode norms are one
    custom-op node each in the top graph, the mask head's once in each slot
    chunk's branch, and no `aten.native_group_norm` anywhere."""
    _, art = exported["torch"]["single"]
    program = torch.export.load(art)
    state_dict, extra = tckpt.restore_bundle(exported["tw"])
    model = KGNet(tckpt.decode_config(extra).model)
    norms = sum(isinstance(m, GroupNorm) for m in model.modules())
    head = sum(isinstance(m, GroupNorm) for m in model.mask_head.modules())
    top, natives = _op_nodes(program.graph_module)
    branches = [_op_nodes(sub) for name, sub in program.graph_module.named_modules()
                if name.startswith("true_graph")]
    assert top == norms - head and natives == 0
    chunks = [b for b in branches if b[0]]
    assert len(chunks) == Config().group.max_detections // Config().infer.mask_chunk
    assert all(b == (head, 0) for b in chunks)
