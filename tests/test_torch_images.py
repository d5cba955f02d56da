"""The port's image dumps (cspn_tpu_torch/utils/images.py) against the JAX
package's (cspn_tpu/utils/images.py).

The port writes its PNGs with the standard library (`write_png`: zlib and
struct; the card's machine has no PIL); PIL, on this host, decodes them.
Every file must decode to the pixels of the file JAX's PIL-based writer
makes from the same arrays, and `eval --dump-images` / `infer --out-dir`
must write JAX's file names.
"""

import os

import numpy as np
import pytest
from PIL import Image

from cspn_tpu.data.transforms import unnormalize as junnormalize
from cspn_tpu.utils import images as jimages
from cspn_tpu_torch.cli import main
from cspn_tpu_torch.data.transforms import unnormalize
from cspn_tpu_torch.utils import images

HW = (64, 96)


def _decoded(path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img)


@pytest.mark.parametrize("kind", ["grey", "rgb", "grey16"])
def test_png_writer_decodes_with_pil(tmp_path, kind):
    rng = np.random.default_rng(0)
    img = {"grey": lambda: rng.integers(0, 256, (17, 31), dtype=np.uint8),
           "rgb": lambda: rng.integers(0, 256, (17, 31, 3), dtype=np.uint8),
           "grey16": lambda: rng.integers(0, 65536, (17, 31), dtype=np.uint16)}[kind]()
    path = images.write_png(str(tmp_path / "a.png"), img)
    with Image.open(path) as decoded:
        assert decoded.mode == {"grey": "L", "rgb": "RGB", "grey16": "I;16"}[kind]
    np.testing.assert_array_equal(_decoded(path), img)
    np.testing.assert_array_equal(images.read_png(path), img)


def test_png_writer_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError, match="write_png takes"):
            images.write_png(str(tmp_path / "b.png"), bad)


def test_unnormalize_matches_jax():
    x = np.random.default_rng(1).standard_normal((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(unnormalize(x), junnormalize(x))


@pytest.mark.parametrize("dataset", ["nyudepth", "kitti", "synthetic"])
@pytest.mark.parametrize("raw", [True, False])
def test_eval_images_decode_to_jax_pixels(tmp_path, dataset, raw):
    """Both packages' save_eval_images and save_pred_image on the same
    arrays, values outside the 8-bit range included (clipped, then
    truncated): the same file names, PIL decodes the same pixels."""
    rng = np.random.default_rng(2)
    rgb = rng.uniform(-0.2, 1.2, (*HW, 3)).astype(np.float32)
    if not raw:
        rgb = rng.standard_normal((*HW, 3)).astype(np.float32)
    gt = rng.uniform(-1, 260, HW).astype(np.float32)
    pred = rng.uniform(-1, 12, HW).astype(np.float32)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    for mod, folder in ((images, mine), (jimages, theirs)):
        mod.save_eval_images(dataset, str(folder), 3, rgb, gt, pred, raw=raw)
        mod.save_pred_image(dataset, str(folder / "infer"), 12, pred)
    names = sorted(os.listdir(theirs / "eval_result"))
    assert names == ["00003_gt.png", "00003_input.png", "00003_pred.png"]
    assert sorted(os.listdir(mine / "eval_result")) == names
    assert os.listdir(mine / "infer") == os.listdir(theirs / "infer") == ["00012_pred.png"]
    for rel in [f"eval_result/{n}" for n in names] + ["infer/00012_pred.png"]:
        with Image.open(mine / rel) as a, Image.open(theirs / rel) as b:
            assert a.mode == b.mode and a.size == b.size
        np.testing.assert_array_equal(_decoded(mine / rel), _decoded(theirs / rel), err_msg=rel)


def test_cli_eval_and_infer_write_jax_file_names(tmp_path, capsys):
    """`eval --dump-images` writes the first run's frames as JAX's
    %05d_{input,gt,pred}.png into <best_model_dir>/eval_result, `infer
    --out-dir` one %05d_pred.png a frame, each the served prediction at
    JAX's scale; `--out` still writes the .npy."""
    common = ["--preset", "synthetic_smoke", "--dataset", "synthetic", "--device", "cpu",
              "--cspn-step", "2", "--best-model-dir", str(tmp_path)]
    assert main(["eval", *common, "--runs", "2", "--max-batches", "1", "--dump-images"]) == 0
    theirs = tmp_path / "jax"
    for i in range(2):  # batch_size_eval 2, one batch: frames 0 and 1
        jimages.save_eval_images("synthetic", str(theirs), i, np.zeros((*HW, 3), np.float32),
                                 np.zeros(HW, np.float32), np.zeros(HW, np.float32), raw=True)
    assert sorted(os.listdir(tmp_path / "eval_result")) == sorted(os.listdir(theirs / "eval_result"))
    for name in os.listdir(tmp_path / "eval_result"):
        assert _decoded(tmp_path / "eval_result" / name).shape[:2] == HW
    out, out_dir = tmp_path / "preds.npy", tmp_path / "served"
    assert main(["infer", *common, "--buckets", "1,2", "--max-frames", "3", "--out", str(out),
                 "--out-dir", str(out_dir)]) == 0
    preds = np.load(out)
    assert preds.shape == (3, *HW)
    assert sorted(os.listdir(out_dir)) == ["00000_pred.png", "00001_pred.png", "00002_pred.png"]
    for i, pred in enumerate(preds):
        jimages.save_pred_image("synthetic", str(theirs / "infer"), i, pred)
        np.testing.assert_array_equal(_decoded(out_dir / f"{i:05d}_pred.png"),
                                      _decoded(theirs / "infer" / f"{i:05d}_pred.png"))
    # without --out-dir: <best_model_dir>/infer_result, as JAX's default
    assert main(["infer", *common, "--buckets", "1", "--max-frames", "1"]) == 0
    assert os.listdir(tmp_path / "infer_result") == ["00000_pred.png"]
    capsys.readouterr()
