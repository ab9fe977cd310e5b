"""The port's FID / FVD feature networks (`models/feature_extractors.py`)
and `metrics.main` with them, against the JAX package's, on the CPU.

InceptionV3Pool3 at 96x96 (its 8x8 and 1x1 stages reached) and I3D at
1x9x63x63 (odd sides: Flax's SAME pads of the stride-2 pools are asymmetric
there) from the same random Flax params through `feature_params_from_jax`;
one torchvision- / pytorch-i3d-named state dict with non-identity BN
through both packages' converters and both `metrics.main`s.

Tolerances:
  * the networks in f32: max error <= 1e-4 of the output's RMS (only the
    order of sums differs);
  * `metrics.main`'s FID and FVD: 1e-3 relative (the Fréchet distance of
    features that agree to 1e-4);
  * `fold_bn`, the converters and the per-pair PSNR/SSIM rows: bitwise.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from orv_tpu.models import feature_extractors as jfe
from orv_tpu.pipelines import metrics as jmetrics
from orv_tpu_torch.models import feature_extractors as tfe
from orv_tpu_torch.models.weights import feature_params_from_jax, write_safetensors
from orv_tpu_torch.pipelines import metrics as tmetrics
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)


def _rel(got, want):
    """(max error, RMS error) over the reference's RMS."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    return err.max() / rms, np.sqrt(np.mean(err ** 2)) / rms


# -- the feature networks --------------------------------------------------------

def _he(params, seed):
    """Every leaf of a JAX feature network's params -> seeded random f32:
    kernels He-scaled (ReLU keeps the activations' size through the depth),
    biases 0.1-scaled, so that every layer shows in the output."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            v = rng.standard_normal(leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("net", ["inception", "i3d"])
def test_feature_network_matches_jax(net):
    """InceptionV3Pool3 at 96x96 (its 8x8 and 1x1 stages reached) and I3D at
    1x9x63x63 (odd sides: Flax's SAME pads of the stride-2 pools are
    asymmetric there), from the same random params through the bridge."""
    if net == "inception":
        jm, tm, shape = jfe.InceptionV3Pool3(), tfe.InceptionV3Pool3(device="cpu"), (2, 96, 96, 3)
    else:
        jm, tm, shape = jfe.I3D(), tfe.I3D(device="cpu"), (1, 9, 63, 63, 3)
    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    params = _he(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x)), seed=4)
    want = np.asarray(jax.jit(jm.apply)(params, x))
    tm.load_state_dict(feature_params_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(np.moveaxis(x, -1, 1))).numpy()
    assert got.shape == want.shape == (shape[0], 2048 if net == "inception" else 400)
    assert _rel(got, want)[0] <= 1e-4


@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (63, 7, 2), (112, 3, 2), (9, 3, 2), (5, 2, 2),
                                   (32, 3, 1), (7, 1, 1), (4, 2, 2)])
def test_same_pads_are_flax_pads(n, k, s):
    """Flax's SAME: low = total // 2, the rest high (224 with 7 and stride 2:
    2 before, 3 after)."""
    assert tfe.same_pads((n,), (k,), (s,)) == [tuple(p) for p in
                                                jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")]


def _torch_named_state_dict(net, seed=5):
    """A torchvision (Inception) or pytorch-i3d (I3D) state dict of seeded
    random values for every conv the port's model holds, with non-identity
    batch norms (gamma, beta, mean, var away from 1, 0, 0, 1)."""
    rng = np.random.default_rng(seed)
    model = tfe.InceptionV3Pool3(device="cpu") if net == "inception" else tfe.I3D(device="cpu")
    conv = "conv" if net == "inception" else "conv3d"
    sd = {}
    for name, m in model.named_modules():
        if isinstance(m, tfe.ConvBN):
            w = m.conv.weight
            sd[f"{name}.{conv}.weight"] = (rng.standard_normal(w.shape)
                                          * np.sqrt(2.0 / np.prod(w.shape[1:])))
            o = w.shape[0]
            sd[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, o)
            sd[f"{name}.bn.bias"] = 0.1 * rng.standard_normal(o)
            sd[f"{name}.bn.running_mean"] = 0.1 * rng.standard_normal(o)
            sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, o)
    if net == "i3d":
        sd["logits.conv3d.weight"] = 0.05 * rng.standard_normal(model.logits.weight.shape)
        sd["logits.conv3d.bias"] = 0.1 * rng.standard_normal(400)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("net", ["inception", "i3d"])
def test_converters_match_jax_bitwise(net):
    """One torch-named state dict with non-identity BN through both
    packages' converters: the folded kernels and biases are the same bits."""
    sd = _torch_named_state_dict(net)
    if net == "inception":
        want, got = jfe.convert_inception_state_dict(sd), tfe.convert_inception_state_dict(sd)
    else:
        want, got = jfe.convert_i3d_state_dict(sd), tfe.convert_i3d_state_dict(sd)
    want = feature_params_from_jax(want)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    tm = tfe.InceptionV3Pool3(device="cpu") if net == "inception" else tfe.I3D(device="cpu")
    tm.load_state_dict(got, strict=True)


def test_fold_bn_matches_jax_bitwise():
    rng = np.random.default_rng(6)
    k = rng.standard_normal((4, 3, 3, 5, 7)).astype(np.float32)  # flax [kt, kh, kw, I, O]
    g, b, m = (rng.standard_normal(7).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.1, 2.0, 7).astype(np.float32)
    jk, jb = jfe.fold_bn(k, g, b, m, v)
    tk, tb = tfe.fold_bn(np.transpose(k, (4, 3, 0, 1, 2)), g, b, m, v)
    np.testing.assert_array_equal(tk, np.transpose(jk, (4, 3, 0, 1, 2)))
    np.testing.assert_array_equal(tb, jb)
    assert tk.dtype == np.float32


def test_feature_entry_points_refuse_a_file(tmp_path):
    """The JAX package reads a folder of safetensors whatever its docstrings
    say (a .pt path reads as an empty dict there); the port refuses a file by
    name."""
    (tmp_path / "w.pt").write_bytes(b"")
    for fn in (tfe.inception_pool3_features, tfe.i3d_features):
        with pytest.raises(ValueError, match="w.pt is not a folder"):
            fn(str(tmp_path / "w.pt"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tfe.i3d_features(str(tmp_path), device="cpu")


def write_feature_weights(root: Path, seed: int = 5):
    """Random torchvision- and pytorch-i3d-named safetensors folders with
    non-identity BN: (inception folder, i3d folder)."""
    out = []
    for net in ("inception", "i3d"):
        folder = root / net
        folder.mkdir(parents=True, exist_ok=True)
        sd = {k: torch.from_numpy(v) for k, v in _torch_named_state_dict(net, seed).items()}
        write_safetensors(folder / "model.safetensors", sd)
        out.append(folder)
    return out


def test_metrics_main_with_fid_and_fvd_matches_jax(tmp_path):
    """`main --inception_weights --i3d_weights` over two 16-frame mp4 pairs:
    the CSV's PSNR, SSIM, FID and FVD fields against JAX's `main` on the same
    files and weights."""
    from orv_tpu_torch.utils import video as tvideo

    rng = np.random.default_rng(8)
    for d in ("gt", "pred"):
        (tmp_path / d).mkdir()
    for name in ("a", "b"):
        frames = rng.integers(40, 220, (16, 32, 48, 3), dtype=np.uint8)
        tvideo.write_video(str(tmp_path / "gt" / f"{name}.mp4"), frames)
        tvideo.write_video(str(tmp_path / "pred" / f"{name}.mp4"),
                           np.clip(frames.astype(int) + rng.integers(-30, 30, frames.shape),
                                   0, 255).astype(np.uint8))
    inc, i3d = write_feature_weights(tmp_path / "weights")
    args = lambda out: ["--gt_dir", str(tmp_path / "gt"), "--pred_dir", str(tmp_path / "pred"),
                        "--output_csv", str(tmp_path / out), "--inception_weights", str(inc),
                        "--i3d_weights", str(i3d)]
    summary = tmetrics.main(args("port.csv") + ["--device", "cpu"])
    jmetrics.main(args("jax.csv"))
    read = lambda f: (tmp_path / f).read_text().splitlines()
    port, ref = read("port.csv"), read("jax.csv")
    assert port[0] == ref[0] == "name,psnr,ssim,fid,fvd_16"
    assert port[1:3] == ref[1:3]  # the per-pair PSNR and SSIM rows
    got = [float(x) for x in port[3].split(",")[1:]]
    want = [float(x) for x in ref[3].split(",")[1:]]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert summary["fid"] > 0 and summary["fvd_16"] > 0
