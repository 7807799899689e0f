"""Import hygiene of the PyTorch port: `kgtpu_torch` and `chip_smoke.py` run
where jax, flax, optax, orbax, cv2, PIL and the JAX package are not
installed.

A static scan of every import statement, a subprocess that imports the
port with those modules blocked, and the entry points' refusal to fall back
to the CPU when CUDA is missing and no device was named.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "kgtpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "kgtpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_import_nothing_forbidden():
    files = _port_files()
    assert len(files) >= 30 and os.path.exists(files[0])
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_and_cv2_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import kgtpu_torch.infer, kgtpu_torch.predictor, kgtpu_torch.convert\n"
        "import kgtpu_torch.ops.groupnorm\n"
        "import kgtpu_torch.losses, kgtpu_torch.train_lib, kgtpu_torch.ops.targets\n"
        "import kgtpu_torch.ops.gaussian, kgtpu_torch.data.transforms\n"
        "import kgtpu_torch.checkpoint, kgtpu_torch.evaluate, kgtpu_torch.coco_export\n"
        "import kgtpu_torch.data.png, kgtpu_torch.data.folder, kgtpu_torch.data.dsb2018\n"
        "import kgtpu_torch.data.jpeg_arith, kgtpu_torch.data.jpeg_lossless\n"
        "import kgtpu_torch.data.tiff_color, kgtpu_torch.data.tiff_jpeg, kgtpu_torch.data.ccitt\n"
        "import kgtpu_torch.data.registry, kgtpu_torch.data.loader\n"
        "import kgtpu_torch.data.draw, kgtpu_torch.data.synthetic\n"
        "import kgtpu_torch.cli.test, kgtpu_torch.cli.eval, kgtpu_torch.cli.bench\n"
        "import kgtpu_torch.cli.train, kgtpu_torch.ops.tiling, kgtpu_torch.ops.nms\n"
        "import kgtpu_torch.ops, kgtpu_torch.ops.roi, kgtpu_torch.ops.decode\n"
        "import kgtpu_torch.models.unet, kgtpu_torch.models.resnet\n"
        "import kgtpu_torch.models.hourglass, kgtpu_torch.models.blocks\n"
        "import kgtpu_torch.data.imread, kgtpu_torch.data.jpeg, kgtpu_torch.data.jpeg_pixels\n"
        "import kgtpu_torch.data.tiff, kgtpu_torch.data.bmp, kgtpu_torch.data.coco\n"
        "import kgtpu_torch.data.neural_cells, kgtpu_torch.utils.host\n"
        "import kgtpu_torch.export, kgtpu_torch.visualize, kgtpu_torch.ops.control\n"
        "import kgtpu_torch.utils.debug, kgtpu_torch.utils.profiling\n"
        "import kgtpu_torch.parallel.mesh, kgtpu_torch.parallel.multihost\n"
        "import kgtpu_torch.parallel.launch\n"
        "import kgtpu_torch.data.pnm, kgtpu_torch.data.sunras, kgtpu_torch.data.hdr\n"
        "import kgtpu_torch.data.gif, kgtpu_torch.data.webp, kgtpu_torch.data.vp8l\n"
        "import kgtpu_torch.data.vp8, kgtpu_torch.data.vp8_pixels, kgtpu_torch.data.vp8_tables\n"
        "import kgtpu_torch.data.jpeg2000, kgtpu_torch.data.j2k_t2, kgtpu_torch.data.j2k_t1\n"
        "import kgtpu_torch.data.j2k_dwt, kgtpu_torch.native\n"
        "assert kgtpu_torch.native.get_lib() is not None, kgtpu_torch.native.error\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "s.loader.exec_module(u.module_from_spec(s))\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from kgtpu_torch.config import tiny_test_config
    from kgtpu_torch.infer import (build_detect_fn, build_ensemble_fn, build_infer_fn,
                                   build_multiscale_fn, build_tiled_infer_fn)
    from kgtpu_torch.models import build_model
    from kgtpu_torch.predictor import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    model = build_model(cfg.model, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_infer_fn(model, cfg)
    for build in (build_detect_fn, build_multiscale_fn):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_ensemble_fn([model], cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_tiled_infer_fn(model, cfg, (256, 256))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, model.state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg.model)


def test_cli_and_from_checkpoint_refuse_cpu_fallback(monkeypatch, tmp_path):
    from kgtpu_torch import checkpoint
    from kgtpu_torch.cli import bench, test
    from kgtpu_torch.config import tiny_test_config
    from kgtpu_torch.models import build_model
    from kgtpu_torch.predictor import Predictor

    cfg = tiny_test_config()
    d = str(tmp_path / "w")
    checkpoint.write_payload(d, 0, {"params": build_model(cfg.model, device="cpu").state_dict()},
                             {"config_json": checkpoint.encode_config(cfg)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor.from_checkpoint(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test.main(["--dataset", "folder", "--data_dir", str(tmp_path), "--weights", d,
                   "--save_dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    from kgtpu_torch.cli import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--dataset", "synthetic", "--save_dir", str(tmp_path / "t")])
    from kgtpu_torch.export import export_infer, load_serving
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_infer(d, str(tmp_path / "m.pt2"), batch=1, input_size=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_serving(str(tmp_path / "m.pt2"))


def test_create_train_state_refuses_cpu_fallback(monkeypatch):
    from kgtpu_torch.config import tiny_test_config
    from kgtpu_torch.train_lib import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(tiny_test_config())
    assert create_train_state(tiny_test_config(), device="cpu").model.training
