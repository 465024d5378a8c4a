"""The port's demo surface against the JAX package's, on the CPU: the
class table, the ``jet`` / ``bwr`` colormaps against matplotlib's, the
rendered catdog overlay, ``Demo`` on the harness tests' tiny ViT in
float64, the device image ops against JAX's g++ library, and that every
new module imports and runs with JAX, scikit-learn, matplotlib, PIL, h5py,
cv2, safetensors and tqdm unimportable.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from transformer_explainability_tpu import demo as jdemo
from transformer_explainability_tpu import native
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch import demo as tdemo
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)
from transformer_explainability_torch.utils import image as timage
from transformer_explainability_torch.utils import render as trender

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            num_classes=10)
GOLDEN_HEAT = os.path.join(REPO, "tests", "golden", "catdog_ta_f64.npy")


def test_imagenet_classes_equal_jax():
    assert tdemo.imagenet_classes() == jdemo.imagenet_classes()


@pytest.mark.parametrize("name", ["jet", "bwr"])
def test_colormaps_match_matplotlib(name):
    cm = pytest.importorskip("matplotlib.cm")
    ref = getattr(cm, name)
    x = np.concatenate([np.linspace(-0.2, 1.2, 4001), [0.0, 1.0, np.nan],
                        np.arange(257) / 256.0])
    ref(0.5)                                    # builds matplotlib's table
    assert np.abs(trender.colormap_table(name) - ref._lut).max() <= 1e-15
    for dt in (np.float32, np.float64):
        want = ref(x.astype(dt))
        assert np.abs(trender.apply_colormap(name, x.astype(dt))
                      - want).max() <= 1e-15
        got_t = trender.apply_colormap(name, torch.from_numpy(x.astype(dt)))
        assert np.abs(got_t.numpy() - want).max() <= 1e-15


def test_hm_to_rgb_matches_jax():
    from transformer_explainability_tpu.utils import render as jrender
    R = np.random.RandomState(0).randn(7, 7)
    np.testing.assert_array_equal(trender.hm_to_rgb(R, scaling=2),
                                  jrender.hm_to_rgb(R, scaling=2))
    np.testing.assert_array_equal(trender.hm_to_rgb(torch.from_numpy(R)),
                                  jrender.hm_to_rgb(R))


def test_render_token_heatmap_matches_jax():
    """The catdog overlay from the committed f64 heatmap: the float overlay
    within 1e-5, its uint8 rendering within one level."""
    heat = np.load(GOLDEN_HEAT)
    img = np.load(os.path.join(REPO, "experiments", "data",
                               "fidelity_truth.npz"))["imgs"][16]
    img01 = (img.transpose(1, 2, 0) * 0.5 + 0.5).astype(np.float32)
    want = jdemo.render_token_heatmap(heat, img01)
    got = tdemo.render_token_heatmap(torch.from_numpy(heat), img01)
    assert got.shape == want.shape == (224, 224, 3)
    assert np.abs(got - want).max() <= 1e-5
    u8 = lambda a: np.round(a * 255).astype(np.int64)
    assert np.abs(u8(got) - u8(want)).max() <= 1


@pytest.fixture
def tiny_demos(monkeypatch):
    """(JAX Demo, port Demo) on the same float64 weights. JAX resizes with
    the port's function (its g++ resize rounds another way, within 1
    float32 ulp, which moves a pixel across a colour bin)."""
    jax.config.update("jax_enable_x64", True)
    monkeypatch.setattr(native, "resize_bilinear_chw", lambda x, h, w: (
        timage.resize_bilinear_chw(torch.tensor(x), h, w).numpy()))
    try:
        jcfg = jvit.ViTConfig(**TINY)
        tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float64),
                            jvit.init_params(jax.random.PRNGKey(0), jcfg))
        yield (jdemo.Demo(tree, jcfg),
               tdemo.Demo(vit_params_from_jax(tree, ViTConfig(**TINY)),
                          ViTConfig(**TINY), device="cpu"))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_demo_matches_jax_f64(tiny_demos, capsys):
    jd, td = tiny_demos
    img = np.random.RandomState(0).randint(0, 255, (32, 32, 3)).astype(
        np.uint8)
    for kw in (dict(class_index=3), dict(method="rollout_attn"),
               dict(class_index=1, method="full")):
        want = jd.generate_visualization(img, **kw)
        got = td.generate_visualization(img, **kw)
        assert got.shape == want.shape == (32, 32, 3), kw
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                   err_msg=str(kw))
    np.testing.assert_allclose(td.predict(img), jd.predict(img), rtol=1e-9)
    want = jd.print_top_classes(img, k=3)
    got = td.print_top_classes(img, k=3)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2:] for r in got], [r[2:] for r in want],
                               rtol=1e-9)
    assert "prob" in capsys.readouterr().out


def test_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = ViTConfig(**TINY)
    from transformer_explainability_torch.models.vit import init_params
    sd = init_params(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdemo.Demo(sd, cfg)


@pytest.mark.parametrize("shape", [(2, 3, 14, 14, 224, 224),
                                   (1, 1, 2, 2, 32, 32),
                                   (3, 2, 7, 5, 33, 17)])
def test_resize_matches_native(shape):
    B, C, H, W, OH, OW = shape
    x = np.random.RandomState(H).randn(B, C, H, W).astype(np.float32)
    want = native.resize_bilinear_chw(x, OH, OW)
    got = timage.resize_bilinear_chw(torch.from_numpy(x), OH, OW)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_normalize_matches_native():
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    want = native.normalize_chw(u8, mean, std)
    got = timage.normalize_chw(torch.from_numpy(u8), mean, std)
    assert got.shape == (2, 3, 9, 7) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


BLOCKED = ("jax", "sklearn", "matplotlib", "PIL", "h5py", "cv2",
           "safetensors", "tqdm")


def test_new_modules_need_no_optional_package(tmp_path):
    """In a fresh process where each of those packages fails to import,
    every new module imports, and the metrics, the render, create_model
    from a .pth, run_seg_eval on an in-memory dataset and
    run_perturbation_eval on an in-memory results object run on the CPU."""
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None            # any import of it now fails
        import numpy as np, torch
        import transformer_explainability_torch as te
        from transformer_explainability_torch import demo
        from transformer_explainability_torch.data import (
            expl_hdf5, folder, imagenet_seg)
        from transformer_explainability_torch.eval import (
            perturbation, seg, visualize)
        from transformer_explainability_torch.models import registry
        from transformer_explainability_torch.params import convert
        from transformer_explainability_torch.utils import (
            checkpoint, image, iou, metrics, profiling, render)
        rng = np.random.RandomState(0)
        s, t = rng.rand(2, 8, 8), (rng.rand(8, 8) > 0.5).astype(int)
        assert 0 <= metrics.get_ap_scores(s[None], t[None])[0] <= 1
        assert render.hm_to_rgb(s[0]).shape == (24, 24, 3)
        fields = dict(img_size=32, patch_size=16, embed_dim=16, depth=2,
                      num_heads=2, num_classes=4)
        cfg, sd = te.create_model("vit_base_patch16_224", device="cpu",
                                  **fields)
        torch.save({{"model": sd}}, "ckpt.pth")
        cfg, sd2 = te.create_model("vit_base_patch16_224",
                                   checkpoint="ckpt.pth", device="cpu",
                                   **fields)
        assert all(torch.equal(sd[k], sd2[k]) for k in sd)
        ds = [(rng.randn(3, 32, 32).astype(np.float32),
               (rng.rand(32, 32) > 0.5).astype(np.int64)) for _ in range(3)]
        res = seg.run_seg_eval(ds, sd, cfg, batch_size=2, device="cpu",
                               save_dir="seg")
        assert all(0 <= v <= 1 for v in res.values()), res

        class Results:
            def __len__(self):
                return 3

            def batches(self, batch_size):
                yield (rng.rand(3, 3, 32, 32).astype(np.float32),
                       rng.rand(3, 1, 32, 32).astype(np.float32),
                       np.array([0, 1, 2]))

        out = perturbation.run_perturbation_eval(Results(), sd, cfg,
                                                 device="cpu")
        assert out["perturbations_hits"].shape == (9, 3)
        assert np.isfinite(out["auc"])
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path),
                         env={"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
