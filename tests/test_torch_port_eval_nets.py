"""The port's metric nets against the JAX package's, on seeded weights in
the published layouts (written by `sin3dm_tpu/evaluation/parity.py`'s
helpers): SSFID's classifier on a 48^3 voxel grid, SIFID's Inception
features at every dims (64/192/768/2048) and LPIPS on 96x96 images.
Features within 1e-5 of the largest |feature| (fp32 convs summed in
another order), Fréchet distances within 1e-4 relative, LPIPS within
1e-5 relative.  Stem-only Inception files load for 64/192 and not for
768; a file holding a pickled module is refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.evaluation import lpips as jl
from sin3dm_tpu.evaluation import parity
from sin3dm_tpu.evaluation import sifid as jsi
from sin3dm_tpu.evaluation import ssfid as jss
from sin3dm_tpu_torch.evaluation import lpips as tl
from sin3dm_tpu_torch.evaluation import sifid as tsi
from sin3dm_tpu_torch.evaluation import ssfid as tss

CPU = torch.device("cpu")
FEAT_TOL = 1e-5
FRECHET_RTOL = 1e-4
LPIPS_RTOL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    files = {
        "cls": parity.synth_clsshapenet_state_dict(0),
        "inception": parity.synth_inception_full_state_dict(0),
        "stem": parity.synth_inception_stem_state_dict(1),
        "alexnet": parity.synth_alexnet_state_dict(0),
        "lpips": parity.synth_lpips_state_dict(0),
    }
    for name, sd in files.items():
        torch.save(sd, d / f"{name}.pth")
    return {name: str(d / f"{name}.pth") for name in files}


def _close(got, want, tol=FEAT_TOL):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_ssfid_features_and_distance(weights):
    rng = np.random.default_rng(0)
    voxels = [(rng.random((48, 48, 48)) > p).astype(np.float32)
              for p in (0.7, 0.6)]
    jp = jss.load_torch_weights(weights["cls"])
    net = tss.load_classifier(weights["cls"], CPU)
    assert sorted(net.state_dict()) == sorted(
        parity.synth_clsshapenet_state_dict(0))
    for layer in (1, 2, 3, 4):
        want = np.asarray(jss.classifier_features(
            jp, jnp.asarray(voxels[0])[None, ..., None], layer))[0]
        with torch.no_grad():
            got = net(torch.from_numpy(voxels[0])[None, None], layer)
        _close(got[0].permute(1, 2, 3, 0).numpy(), want)
    stats_j = [jss.activation_statistics(jp, v) for v in voxels]
    stats_t = [tss.activation_statistics(net, torch.from_numpy(v))
               for v in voxels]
    want = jss.frechet_distance(*stats_j[0], *stats_j[1])
    got = tss.frechet_distance(*stats_t[0], *stats_t[1])
    assert abs(got - want) <= FRECHET_RTOL * abs(want)
    # the distance itself, on the same statistics
    assert tss.frechet_distance(*stats_j[0], *stats_j[1]) == want


@pytest.mark.parametrize("dims", tsi.DIMS)
def test_sifid_features(weights, dims):
    img = np.random.default_rng(1).random((96, 96, 3)).astype(np.float32)
    jp = jsi.load_torch_weights(weights["inception"])
    want = np.asarray(jsi.stem_features(jp, jnp.asarray(img)[None],
                                        dims))[0]
    net = tsi.load_inception(weights["inception"], dims, CPU)
    with torch.no_grad():
        got = net(torch.from_numpy(img).permute(2, 0, 1)[None])
    _close(got[0].permute(1, 2, 0).numpy(), want)


def test_sifid_distance_and_stem_only_files(weights):
    rng = np.random.default_rng(2)
    a, b = (rng.random((96, 96, 3)).astype(np.float32) for _ in range(2))
    for dims in (64, 192):
        jp = jsi.load_torch_weights(weights["stem"])
        net = tsi.load_inception(weights["stem"], dims, CPU)
        want = jss.frechet_distance(*jsi.image_statistics(jp, a, dims),
                                    *jsi.image_statistics(jp, b, dims))
        got = tss.frechet_distance(*tsi.image_statistics(net, a),
                                   *tsi.image_statistics(net, b))
        assert abs(got - want) <= FRECHET_RTOL * abs(want), dims
    with pytest.raises(KeyError):
        tsi.load_inception(weights["stem"], 768, CPU)
    with pytest.raises(ValueError, match="dims"):
        tsi.InceptionFeatures(100)


def test_lpips(weights):
    rng = np.random.default_rng(3)
    imgs = rng.random((3, 96, 96, 3)).astype(np.float32) * 2 - 1
    ja = jl.load_alexnet_weights(weights["alexnet"])
    jw = jl.load_lpips_lin_weights(weights["lpips"])
    net = tl.load_lpips(weights["alexnet"], weights["lpips"], CPU)
    x = jnp.asarray(imgs[:1])
    with torch.no_grad():
        t = torch.from_numpy(imgs[:1]).permute(0, 3, 1, 2)
        got = net.alexnet((t - net.mu) / net.sigma)
    want = jl.alexnet_fmaps(ja, (x - jl._MU) / jl._SIGMA)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g[0].permute(1, 2, 0).numpy(), np.asarray(w)[0])
    want = jl.calculate_lpips_given_images(ja, jw, imgs)
    got = tl.calculate_lpips_given_images(net, imgs)
    assert abs(got - want) <= LPIPS_RTOL * abs(want)


def test_pickled_module_is_refused(tmp_path):
    path = tmp_path / "module.pth"
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="module.pth"):
        tss.load_classifier(str(path), CPU)
    torch.save([torch.zeros(2)], tmp_path / "list.pth")
    with pytest.raises(ValueError, match="not a state dict"):
        tss.load_state_dict(str(tmp_path / "list.pth"))
