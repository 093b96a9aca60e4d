"""The port's reference-checkpoint loaders
(``acf_tpu_torch/compat/reference_checkpoints.py``, a copy of
``acf_tpu/compat/reference_checkpoints.py``) on the files
``tests/test_compat.py`` writes: a Keras h5 save (with and without Adam
slots under ``optimizer_weights``) and a TF1 Saver checkpoint (with an
Adagrad slot beside the embeddings), each loaded by both packages and
equal; skipped where h5py or tensorflow is absent, as that file does."""

import numpy as np
import pytest

from acf_tpu.compat import reference_checkpoints as jax_compat
from acf_tpu_torch.compat import reference_checkpoints as compat


def both_equal(path, fn_name, P, Q):
    got = getattr(compat, fn_name)(path)
    want = getattr(jax_compat, fn_name)(path)
    assert set(got) == set(want) == {"P", "Q"}
    for k, ref in (("P", P), ("Q", Q)):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], ref)


@pytest.mark.parametrize("with_slots", [False, True], ids=["weights", "full_save"])
def test_keras_h5_embeddings(tmp_path, with_slots):
    h5py = pytest.importorskip("h5py")
    P = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    Q = np.random.default_rng(1).standard_normal((12, 4)).astype(np.float32)
    path = str(tmp_path / "model.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        g.create_group("uEmb").create_group("uEmb").create_dataset("embeddings:0", data=P)
        g.create_group("iEmb").create_group("iEmb").create_dataset("embeddings:0", data=Q)
        if with_slots:  # Adam slots of the same names and shapes must not shadow them
            o = f.create_group("optimizer_weights").create_group("Adam")
            o.create_group("uEmb").create_dataset("m:0", data=np.zeros_like(P))
            o.create_group("iEmb").create_dataset("v:0", data=np.zeros_like(Q))
    both_equal(path, "load_keras_h5_embeddings", P, Q)


@pytest.mark.parametrize("with_slot", [False, True], ids=["embeddings", "adagrad_slot"])
def test_tf_saver_checkpoint(tmp_path, with_slot):
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    P = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
    Q = np.random.default_rng(3).standard_normal((9, 4)).astype(np.float32)
    graph = tf1.Graph()
    with graph.as_default():
        tables = {"embedding_P": tf1.get_variable("embedding_P", initializer=P),
                  "embedding_Q": tf1.get_variable("embedding_Q", initializer=Q)}
        if with_slot:  # the exact name wins over the slot that contains it
            tables["embedding_P/Adagrad"] = tf1.get_variable("embedding_P/Adagrad",
                                                             initializer=np.zeros_like(P))
        saver = tf1.train.Saver(tables)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, str(tmp_path / "weights"), global_step=5)
    both_equal(str(tmp_path), "load_tf_embeddings", P, Q)
