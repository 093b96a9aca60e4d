"""Migration loaders for the reference's checkpoint formats.

The port's own copy of ``acf_tpu/compat/reference_checkpoints.py``, so that
the port imports nothing of the JAX package.

A user switching from the reference brings two kinds of artifacts
(SURVEY.md §5 checkpoint row):

  * TF1 ``tf.train.Saver`` checkpoints of ``{embedding_P, embedding_Q}``
    under ``Pretrain/<data>/<MF_BPR|APR>/embed_<d>/<ts>/weights-<epoch>``
    (reference evaluation_adv.py:235, 302-306);
  * Keras ``.h5`` saves whose embedding layers are named ``uEmb``/``iEmb``
    (reference BPR.py:59-65, run.py:257-272).

Both load into the MF-family param dict {"P": [U,d], "Q": [I,d]} as numpy
arrays (``acf_tpu_torch.compat.jax_params.params_from_numpy`` puts them on a
device) for continued training or serving. TensorFlow and h5py are imported
inside the functions: nothing else of the port needs them.
"""

from __future__ import annotations

import numpy as np


def load_tf_embeddings(ckpt_prefix: str):
    """Read a TF1 Saver checkpoint → {"P", "Q"} numpy arrays.

    ``ckpt_prefix`` is the Saver prefix (e.g. ``.../weights-120``) or a
    directory containing a ``checkpoint`` state file.
    """
    import os

    import tensorflow as tf  # lazy; heavyweight

    prefix = ckpt_prefix
    if os.path.isdir(prefix):
        state = tf.train.get_checkpoint_state(prefix)
        assert state and state.model_checkpoint_path, f"no checkpoint in {prefix}"
        prefix = state.model_checkpoint_path
    reader = tf.train.load_checkpoint(prefix)
    names = list(reader.get_variable_to_shape_map())
    out = {}
    for key, target in (("embedding_P", "P"), ("embedding_Q", "Q")):
        # exact name first; a substring search would also hit optimizer
        # slots like 'embedding_P/Adagrad' in full-var checkpoints
        if key in names:
            pick = key
        else:
            match = sorted(n for n in names
                           if key in n and "/" not in n.replace(key, "", 1))
            assert len(match) == 1, (
                f"{key} ambiguous/missing in {prefix} (candidates: "
                f"{match or names})")
            pick = match[0]
        out[target] = np.asarray(reader.get_tensor(pick), np.float32)
    return out


def load_keras_h5_embeddings(path: str, user_layer: str = "uEmb",
                             item_layer: str = "iEmb"):
    """Read a Keras .h5 model save → {"P", "Q"} numpy arrays.

    Searches the weight groups for the named embedding layers (the h5
    layout nests layer groups under ``model_weights``).
    """
    import h5py

    found = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            # full .h5 saves also carry optimizer_weights/<opt>/<layer>/…
            # Adam slots whose names contain the layer name and match the
            # embedding shape — restrict to the model_weights tree (or a
            # bare weights-only file) and keep the FIRST hit
            if name.startswith("optimizer_weights"):
                return
            if "P" not in found and (f"/{user_layer}/" in f"/{name}"):
                found["P"] = np.asarray(obj, np.float32)
            elif "Q" not in found and (f"/{item_layer}/" in f"/{name}"):
                found["Q"] = np.asarray(obj, np.float32)

        f.visititems(visit)
    assert "P" in found and "Q" in found, (
        f"embedding layers {user_layer}/{item_layer} not found in {path}")
    return found
