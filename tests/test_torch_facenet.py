"""The port's FaceNet mining, loss, embedding and LFW pieces against the JAX
package's, on the CPU.

- ``select_triplets`` fed JAX's own Gumbel draws (``jax.random.gumbel(key, (n, n,
  n))``, the draw inside the JAX function) returns JAX's ``(n², 3)`` triplets
  and ``(n²,)`` valid mask exactly, row for row, also with invalid (padded)
  images and a person left with one image; the same noise handed over as the
  blocks' ``(P, I, I, n)`` gives the same output; with a ``torch.Generator`` every
  valid triplet satisfies the mining condition and no invalid image is used.
- ``triplet_loss`` with and without ``valid`` (all invalid included) and
  ``euclidean_distance_sq`` within 1e-6 of JAX's.
- ``get_embeddings`` over 5 images in batches of 2 and 4 (the last padded) equal
  to JAX's within 1e-5 and to one unpadded batch; the model's mode is kept.
- ``lfw.evaluate`` equal to JAX's within 1e-12 (both distance metrics, with and
  without the mean subtracted, 60 and 37 pairs); the port's ``KFold`` splits
  equal sklearn's for n in {10, 37, 100, 6000}; ``read_pairs`` and ``get_paths``
  equal JAX's on a temporary tree with a missing file.
- ``FaceDataset`` draws equal JAX's at one seed over three batches.
- The four backbones' cost at 160 px on the meta device (``torch.utils.
  flop_counter``): FLOPs per image and conv counts, the figures ``PERF.md``
  predicts the card's times from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold as SkKFold
from torch.utils.flop_counter import FlopCounterMode

from tmv_tpu.models.facenet import FaceNetModel as JaxFaceNet
from tmv_tpu.models.facenet import dataset as jax_dataset
from tmv_tpu.models.facenet import lfw as jax_lfw
from tmv_tpu.models.facenet import model as jax_model
from tmv_tpu.ops import losses as jax_losses
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.facenet import FaceNetModel, dataset, get_embeddings, lfw
from tmv_tpu_torch.models.facenet.model import select_triplets
from tmv_tpu_torch.ops import losses
from torch_port_cases import seeded_variables, write_face_set, write_pairs
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

# the port's torch work on one thread: no OpenMP oversubscription under test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def mining_case(p_num, i_num, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 0.5, size=(p_num, 1, d))
    emb = (centers + rng.normal(0, 0.5, size=(p_num, i_num, d))).astype(np.float32)
    valid = np.ones((p_num, i_num), bool)
    if p_num > 2:
        valid[1, -2:] = False                      # a padded person
        valid[2, 1:] = False                       # a person with one image
    return emb, valid


@pytest.mark.parametrize("p_num,i_num,d,seed", [(3, 4, 8, 0), (4, 5, 16, 1), (2, 6, 4, 2),
                                                (5, 3, 6, 3)])
def test_select_triplets_equals_jax_fed_its_draws(p_num, i_num, d, seed):
    emb, valid = mining_case(p_num, i_num, d, seed)
    key = jax.random.key(seed)
    want_t, want_v = (np.asarray(a) for a in jax_model.select_triplets(
        jnp.asarray(emb), jnp.asarray(valid), 0.2, key))
    n = p_num * i_num
    gumbel = np.array(jax.random.gumbel(key, (n, n, n)))
    got_t, got_v = select_triplets(torch.from_numpy(emb), torch.from_numpy(valid), 0.2,
                                   gumbel=torch.from_numpy(gumbel))
    assert got_t.shape == (n * n, 3) and got_v.shape == (n * n,)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert want_v.any() and not want_v.all()
    blocks = gumbel.reshape(p_num, i_num, p_num, i_num, n)[np.arange(p_num), :, np.arange(p_num)]
    again_t, again_v = select_triplets(torch.from_numpy(emb), torch.from_numpy(valid), 0.2,
                                       gumbel=torch.from_numpy(blocks))
    assert torch.equal(again_t, got_t) and torch.equal(again_v, got_v)


def test_select_triplets_with_a_generator_keeps_the_mining_condition():
    p_num, i_num, d = 4, 5, 8
    emb, valid = mining_case(p_num, i_num, d, 4)
    triplets, tvalid = select_triplets(torch.from_numpy(emb), torch.from_numpy(valid), 0.2,
                                       generator=torch.Generator().manual_seed(0))
    triplets = triplets[tvalid].numpy()
    flat, ok = emb.reshape(-1, d), valid.reshape(-1)
    person, image = np.repeat(np.arange(p_num), i_num), np.tile(np.arange(i_num), p_num)
    assert len(triplets) > 0
    for a, p, n in triplets:
        assert ok[a] and ok[p] and ok[n]
        assert person[a] == person[p] and image[p] > image[a] and person[n] != person[a]
        pos = np.sum((flat[a] - flat[p]) ** 2)
        neg = np.sum((flat[a] - flat[n]) ** 2)
        assert (neg - pos < 0.2 and pos < neg) or neg < pos


@pytest.mark.parametrize("with_valid", [None, "some", "none"])
def test_triplet_loss_matches_jax(with_valid):
    rng = np.random.default_rng(6)
    a, p, n = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(3))
    valid = {None: None, "some": rng.uniform(size=8) < 0.6, "none": np.zeros(8, bool)}[with_valid]
    want = float(jax_losses.triplet_loss(jnp.asarray(a), jnp.asarray(p), jnp.asarray(n), 0.5,
                                         valid=None if valid is None else jnp.asarray(valid)))
    got = float(losses.triplet_loss(torch.from_numpy(a), torch.from_numpy(p), torch.from_numpy(n),
                                    0.5, valid=None if valid is None else torch.from_numpy(valid)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    np.testing.assert_allclose(
        losses.euclidean_distance_sq(torch.from_numpy(a), torch.from_numpy(p)).numpy(),
        np.asarray(jax_losses.euclidean_distance_sq(jnp.asarray(a), jnp.asarray(p))), rtol=1e-6)


def test_get_embeddings_pads_the_last_batch():
    flax_model = JaxFaceNet(16)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 80, 80, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(7)))
    model = FaceNetModel(16, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    images = np.random.default_rng(8).uniform(0, 1, (5, 80, 80, 3)).astype(np.float32)
    whole = get_embeddings(model.train(), images, 5)
    assert model.training                            # the mode is put back
    for batch in (2, 4):
        want = jax_model.get_embeddings(flax_model, variables, images, batch)
        got = get_embeddings(model, images, batch)
        assert got.shape == want.shape == (5, 16)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6)


def lfw_case(n_pairs, seed):
    rng = np.random.default_rng(seed)
    issame = rng.uniform(size=n_pairs) < 0.5
    emb = rng.normal(size=(2 * n_pairs, 8))
    emb[1::2] = np.where(issame[:, None], emb[0::2] + rng.normal(0, 0.4, (n_pairs, 8)),
                         emb[1::2])
    return emb / np.linalg.norm(emb, axis=1, keepdims=True), issame


@pytest.mark.parametrize("n_pairs,metric,subtract", [(60, 0, False), (60, 1, False),
                                                     (37, 0, True), (37, 1, True)])
def test_lfw_evaluate_equals_jax(n_pairs, metric, subtract):
    emb, issame = lfw_case(n_pairs, n_pairs + metric)
    want = jax_lfw.evaluate(emb, issame, distance_metric=metric, subtract_mean=subtract)
    got = lfw.evaluate(emb, issame, distance_metric=metric, subtract_mean=subtract)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert 0.5 < got[2].mean() <= 1.0


@pytest.mark.parametrize("n", [10, 37, 100, 6000])
def test_kfold_equals_sklearn(n):
    for k in (10, 3):
        want = list(SkKFold(n_splits=k, shuffle=False).split(np.arange(n)))
        got = list(lfw.KFold(n_splits=k, shuffle=False).split(np.arange(n)))
        assert len(got) == len(want) == k
        for (gt, gs), (wt, ws) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gs, ws)
    with pytest.raises(ValueError):
        list(lfw.KFold(n_splits=11).split(np.arange(10)))


def test_read_pairs_and_get_paths_equal_jax(tmp_path, capsys):
    names = write_face_set(tmp_path / "lfw", people=3, images=3, size=32)
    pairs_file = write_pairs(tmp_path / "pairs.txt", names, 3, count=12)
    with open(pairs_file, "a") as f:
        f.write(f"{names[0]}\t1\tnobody\t1\n")      # a missing file: skipped
    want_pairs = jax_lfw.read_pairs(str(pairs_file))
    got_pairs = lfw.read_pairs(str(pairs_file))
    assert [list(p) for p in got_pairs] == [list(p) for p in want_pairs]
    want = jax_lfw.get_paths(str(tmp_path / "lfw"), want_pairs)
    got = lfw.get_paths(str(tmp_path / "lfw"), got_pairs)
    assert got == want and len(got[1]) == 12 and any(got[1]) and not all(got[1])
    assert "Skipped 1 image pairs" in capsys.readouterr().out


def test_face_dataset_draws_equal_jax(tmp_path):
    write_face_set(tmp_path, people=5, images=4, size=16)
    for extra in range(3):                        # uneven counts; a person with 1 image is left out
        (tmp_path / "person_1" / f"person_1_{9 + extra:04d}.jpg").write_bytes(
            (tmp_path / "person_1" / "person_1_0001.jpg").read_bytes())
    (tmp_path / "solo").mkdir()
    (tmp_path / "solo" / "solo_0001.jpg").write_bytes(
        (tmp_path / "person_0" / "person_0_0001.jpg").read_bytes())
    want = jax_dataset.FaceDataset(str(tmp_path), 3, 5, seed=11)
    got = dataset.FaceDataset(str(tmp_path), 3, 5, seed=11)
    assert got.people == want.people and len(got.people) == 5
    for _ in range(3):
        assert got.sample_people() == want.sample_people()


@pytest.mark.parametrize("backbone,flops,convs", [
    ("InceptionResNetV1", 2_806_570_688, 127), ("InceptionResNetV2", 4_205_089_472, 132),
    ("InceptionV4", 5_522_634_432, 149), ("RepVGG", 12_847_677_440, 56)])
def test_flops_at_160(backbone, flops, convs):
    model = FaceNetModel(512, backbone, device="meta").eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 160, 160, 3, device="meta"))
    assert counter.get_total_flops() == flops
    assert sum(isinstance(m, torch.nn.Conv2d) for m in model.modules()) == convs
