"""The port's evaluation harnesses (``eval/seg.py``, ``eval/visualize.py``,
``eval/perturbation.py``), their metrics and data readers against the JAX
package's, on the CPU.

The JAX harness tests' tiny ViT (img 32, patch 16, D 32, 2 blocks, 10
classes), seeded JAX weights exported to the port, seeded numpy data.
Metrics: the port's numpy versions against JAX's (scikit-learn) at rtol
1e-12 on inputs with ties, all-positive and all-negative labels and
``ignore_index``. Harnesses in float64: ``run_seg_eval``'s four metrics at
rtol 1e-9 and its saved PR curve; ``results.hdf5`` from both packages'
``compute_saliency_and_save`` (images and targets bitwise, maps within
1e-6); ``run_perturbation_eval`` on one file (hits equal, the differences
and the AUC at rtol 1e-9). Then the three CLIs with ``--device cpu``, and
the entry points' default device: the card, with no CPU fallback.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.data.expl_hdf5 import (
    ImagenetResults as JaxResults)
from transformer_explainability_tpu.eval import perturbation as jpert
from transformer_explainability_tpu.eval import seg as jseg
from transformer_explainability_tpu.eval import visualize as jvis
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.utils import iou as jiou
from transformer_explainability_tpu.utils import metrics as JM
from transformer_explainability_torch.data.expl_hdf5 import ImagenetResults
from transformer_explainability_torch.eval import perturbation as tpert
from transformer_explainability_torch.eval import seg as tseg
from transformer_explainability_torch.eval import visualize as tvis
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)
from transformer_explainability_torch.utils import iou as tiou
from transformer_explainability_torch.utils import metrics as TM
from transformer_explainability_torch.utils.image import resize_bilinear_chw

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            num_classes=10)
CFG = ViTConfig(**TINY)
JCFG = jvit.ViTConfig(**TINY)
RTOL = 1e-9


@pytest.fixture(scope="module")
def weights():
    """(JAX float64 params as numpy arrays, which JAX reads in float64
    under the ``x64`` fixture; the port's float64 state dict) of one seeded
    init."""
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float64),
                        jvit.init_params(jax.random.PRNGKey(0), JCFG))
    return tree, vit_params_from_jax(tree, CFG)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


class _SynthSegDataset:
    """Stands in for ImagenetSegmentation: (normalised image, binary label),
    as in tests/test_eval_harnesses.py."""

    def __init__(self, n=6, size=32, seed=0):
        rng = np.random.RandomState(seed)
        self.items = []
        for _ in range(n):
            img = rng.randn(3, size, size).astype(np.float32)
            lbl = (rng.rand(size, size) > 0.5).astype(np.int64)
            self.items.append((img, lbl))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _metric_inputs(kind, seed):
    """(K=2, H, W) scores with ties and (H, W) labels: mixed, all 1, all 0,
    or mixed with ignored (-1) pixels."""
    rng = np.random.RandomState(seed)
    scores = (rng.randint(0, 6, (2, 12, 12)) / 5.0).astype(np.float32)
    labels = (rng.rand(12, 12) > 0.6).astype(np.int64)
    if kind == "all_pos":
        labels[:] = 1
    elif kind == "all_neg":
        labels[:] = 0
    elif kind == "ignore":
        labels[rng.rand(12, 12) > 0.7] = -1
    return scores, labels


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-12,
                               atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", ["mixed", "all_pos", "all_neg", "ignore"])
def test_metrics_match_jax(kind):
    scores, labels = _metric_inputs(kind, seed=len(kind))
    batch_s, batch_l = scores[None], labels[None]
    binary = (scores[1] > 0.5).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for fn, args in (
                ("batch_pix_accuracy", (scores, labels)),
                ("batch_intersection_union", (scores, labels, 2)),
                ("get_ap_scores", (batch_s, batch_l)),
                ("get_f1_scores", (binary, labels)),
                ("get_iou", (binary[None] > 0, labels[None].clip(0))),
                ("batch_precision_recall", (scores[1], labels))):
            for g, w in zip(np.atleast_1d(getattr(TM, fn)(*args)),
                            np.atleast_1d(getattr(JM, fn)(*args))):
                _close(g, w)
        if kind != "ignore":              # labels must be binary here
            _close(TM.get_ap_multiclass(batch_s[:, 1], batch_l),
                   JM.get_ap_multiclass(batch_s[:, 1], batch_l))
        for fn in ("get_pr", "get_roc"):
            for g, w in zip(getattr(TM, fn)(batch_s, batch_l)[0],
                            getattr(JM, fn)(batch_s, batch_l)[0]):
                assert g.shape == w.shape, fn
                _close(g, w)


def test_metrics_reject_what_sklearn_rejects():
    with pytest.raises(ValueError):
        TM.average_precision_score(np.array([0, 2, 2]), np.array([.1, .2, .3]))
    with pytest.raises(ValueError):
        TM.average_precision_score(np.array([0, 1]), np.array([np.nan, 1.0]))


def test_iou_matches_jax_bitwise():
    rng = np.random.RandomState(4)
    pred = rng.randn(2, 3, 8, 8).astype(np.float32)          # (N, K, H, W)
    tgt = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 8, 8))]
    tgt = tgt.transpose(0, 3, 1, 2)
    for kw in ({}, dict(ignore_index=1), dict(normalized=True,
                                              ignore_index=[0])):
        a, b = tiou.IoU(3, **kw), jiou.IoU(3, **kw)
        for m in (a, b):
            m.add(pred, tgt)
            m.add(pred.argmax(1), tgt.argmax(1))
        (ia, ma), (ib, mb) = a.value(), b.value()
        np.testing.assert_array_equal(ia, ib)
        assert ma == mb or (np.isnan(ma) and np.isnan(mb))
    cm = tiou.ConfusionMatrix(3)
    cm.add(rng.randn(12, 3), rng.randint(0, 3, 12))
    ref = jiou.ConfusionMatrix(3)
    ref.conf = cm.conf.copy()
    np.testing.assert_array_equal(cm.value(), ref.value())


@pytest.mark.parametrize("method", ["transformer_attribution", "rollout",
                                    "full_lrp"])
def test_seg_eval_matches_jax_f64(weights, x64, tmp_path, method,
                                  monkeypatch):
    """Both harnesses explain in float64 and post-process in float32. The
    seg metrics hinge on ties in the upsampled float32 maps (a 2 × 2 grid
    to 32 × 32 here), and JAX's resize is its g++ library, which the
    compiler contracts into FMAs where PyTorch rounds each product: the two
    agree within 1 float32 ulp (held at rtol 1e-6 in
    tests/test_torch_demo.py), not bit for bit. So JAX's harness upsamples
    with the port's function here, and the comparison holds everything
    else: the explanations, the post-processing and the metrics."""
    jp, sd = weights
    ds = _SynthSegDataset(size=CFG.img_size)
    monkeypatch.setattr(jseg, "upsample_bilinear", lambda x, size=224: (
        tseg.upsample_bilinear(torch.tensor(np.asarray(x)), size)
        .numpy()))
    want = jseg.run_seg_eval(ds, jp, JCFG, method=method, batch_size=4,
                             save_dir=str(tmp_path / "jax"), progress=False)
    got = tseg.run_seg_eval(ds, sd, CFG, method=method, batch_size=4,
                            save_dir=str(tmp_path / "port"), progress=False,
                            device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    for name in ("precision.npy", "recall.npy"):
        a, b = (np.load(tmp_path / d / name) for d in ("port", "jax"))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)
    assert any(n.startswith("result_mIoU_")
               for n in os.listdir(tmp_path / "port"))


def _vis_data(n=6, B=4, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, 3, 32, 32).astype(np.float32)
    tgts = rng.randint(0, CFG.num_classes, n)
    return [(imgs[s:s + B], tgts[s:s + B]) for s in range(0, n, B)]


@pytest.mark.parametrize("method,vis_class", [
    ("transformer_attribution", "target"), ("rollout", "top")])
def test_visualize_matches_jax_f64(weights, x64, tmp_path, method,
                                   vis_class, monkeypatch):
    """JAX's maps are resized by the port's function, as in the seg test
    above: the per-image min-max divides by a map's range, which turns the
    two resizes' 1-ulp gap into up to 3e-5 on rollout's flat maps."""
    pytest.importorskip("h5py")
    from transformer_explainability_tpu import native
    monkeypatch.setattr(native, "resize_bilinear_chw", lambda x, h, w: (
        resize_bilinear_chw(torch.tensor(x), h, w).numpy()))
    jp, sd = weights
    data = _vis_data()
    a, b = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    assert tvis.compute_saliency_and_save(iter(data), sd, a, CFG, method,
                                          vis_class, device="cpu") == 6
    assert jvis.compute_saliency_and_save(iter(data), jp, b, JCFG, method,
                                          vis_class) == 6
    (ia, va, ta), (ib, vb, tb) = ImagenetResults(a)[:], JaxResults(b)[:]
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(ta, tb)
    assert va.shape == vb.shape == (6, 1, 32, 32) and va.dtype == vb.dtype
    np.testing.assert_allclose(va, vb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("neg", [False, True])
def test_perturbation_matches_jax_f64(weights, x64, tmp_path, neg):
    pytest.importorskip("h5py")
    jp, sd = weights
    path = str(tmp_path / "results.hdf5")
    data = _vis_data(seed=1)
    # half the targets are the model's own predictions, so that the hits
    # are mixed and their equality is not vacuous
    with torch.no_grad():
        from transformer_explainability_torch.explain.generator import (
            Explainer)
        ex = Explainer(sd, CFG, "cpu")
        pred = ex.model(torch.from_numpy((data[0][0] - 0.5) / 0.5)
                        .double()).argmax(1).numpy()
    data[0][1][:2] = pred[:2]
    jvis.compute_saliency_and_save(iter(data), jp, path, JCFG,
                                   vis_class="target")
    want = jpert.run_perturbation_eval(JaxResults(path), jp, JCFG, neg=neg,
                                       batch_size=4, progress=False)
    got = tpert.run_perturbation_eval(ImagenetResults(path), sd, CFG,
                                      neg=neg, batch_size=4, progress=False,
                                      save_dir=str(tmp_path / "port"),
                                      device="cpu")
    assert sorted(got) == sorted(want)
    assert 0 < want["perturbations_hits"].sum() < want[
        "perturbations_hits"].size
    for k in ("model_hits", "perturbations_hits"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-12,
                                   err_msg=k)
    assert os.path.exists(tmp_path / "port" / "perturbations_hits.npy")


def _tiny_cli(monkeypatch):
    for mod in (tseg, tvis, tpert):
        monkeypatch.setattr(mod, "VIT_BASE_16_224", CFG)


def test_visualize_and_perturbation_cli(tmp_path, monkeypatch):
    """Stage A CLI -> results.hdf5 -> stage B CLI on a PIL image folder, as
    tests/test_cli.py drives JAX's, plus --device cpu."""
    pytest.importorskip("h5py")
    Image = pytest.importorskip("PIL.Image")
    _tiny_cli(monkeypatch)
    rng = np.random.RandomState(0)
    img_dir = tmp_path / "imagenet"
    for c in ("n01", "n02"):
        os.makedirs(img_dir / c)
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
                img_dir / c / f"{i}.png")
    out_dir = tmp_path / "vis"
    tvis.main(["--imagenet-dir", str(img_dir), "--method", "rollout",
               "--batch-size", "2", "--out-dir", str(out_dir),
               "--device", "cpu"])
    method_dir = out_dir / "rollout" / "top" / "not_ablation"
    assert len(ImagenetResults(str(method_dir))) == 4
    tpert.main(["--vis-dir", str(method_dir), "--batch-size", "2",
                "--save-dir", str(tmp_path / "pert"), "--device", "cpu"])
    assert (tmp_path / "pert" / "perturbations_hits.npy").exists()
    tpert.main(["--vis-dir", str(method_dir), "--neg", "--batch-size", "4",
                "--device", "cpu"])


def test_seg_cli(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    pytest.importorskip("PIL")
    from test_imagenet_seg_data import _make_mat
    import transformer_explainability_torch.data.imagenet_seg as ds_mod
    _tiny_cli(monkeypatch)
    mat = tmp_path / "gtsegs.mat"
    _make_mat(str(mat), n=3, H=16, W=16)
    orig = ds_mod.ImagenetSegmentation
    monkeypatch.setattr(ds_mod, "ImagenetSegmentation",
                        lambda path, size=224: orig(path, size=32))
    tseg.main(["--imagenet-seg-path", str(mat), "--method",
               "transformer_attribution", "--batch-size", "2",
               "--save-dir", str(tmp_path / "run"), "--save-images", "2",
               "--device", "cpu"])
    run_dir = tmp_path / "run" / "transformer_attribution"
    assert any(n.startswith("result_mIoU_") for n in os.listdir(run_dir))
    assert os.path.exists(run_dir / "images" / "heatmap_0.png")
    with pytest.raises(NotImplementedError, match="A8"):
        tseg.main(["--imagenet-seg-path", str(mat), "--mesh", "2",
                   "--device", "cpu"])


def test_entry_points_default_to_the_card(weights, tmp_path):
    """Called without a device on a machine with no card, every entry point
    raises: none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, sd = weights
    from transformer_explainability_torch.demo import Demo
    ds = _SynthSegDataset(n=2)

    class _Results:
        def __len__(self):
            return 2

        def batches(self, batch_size):
            yield (np.zeros((2, 3, 32, 32), np.float32),
                   np.zeros((2, 1, 32, 32), np.float32), np.zeros(2, int))

    calls = [lambda: tseg.run_seg_eval(ds, sd, CFG, progress=False),
             lambda: tvis.compute_saliency_and_save(
                 iter(_vis_data()), sd, str(tmp_path / "r.hdf5"), CFG),
             lambda: tpert.run_perturbation_eval(_Results(), sd, CFG,
                                                 progress=False),
             lambda: Demo(sd, CFG)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
