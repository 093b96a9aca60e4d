"""Offline preprocessing: raw interaction logs → leave-one-out .rating files.

The port's own copy of ``acf_tpu/data/process.py`` (pandas and numpy on the
host, as there), so that the port imports nothing of the JAX package.

Re-implements reference process_data.py:5-52: 10-core filtering, 1-based
category reindex, chronological sort, per-user leave-one-out split into
``<name>.train.rating`` / ``<name>.test.rating`` TSVs (uid, iid, rating,
timestamp), plus the ``-sort`` (dedup-free) and ``-sort-dup`` variants.

``-sort-dup`` follows the reference exactly (process_data.py:27
``df.drop_duplicates(['uid', 'iid'])``): for every (uid, iid) pair only
the chronologically FIRST interaction survives, even when the repeats are
far apart — see :func:`drop_duplicate_pairs`. The stricter
consecutive-only collapse (:func:`collapse_consecutive_duplicates`) is
kept as a separate opt-in (``dedup="consecutive"``) for check-in data
where only immediate revisits should merge.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd


def core_filter(df: pd.DataFrame, min_items: int = 10,
                min_users: int = 10) -> pd.DataFrame:
    """Keep users with ≥ ``min_items`` distinct items and items with ≥
    ``min_users`` distinct users (reference Dataset.py:11-16 /
    process_data semantics)."""
    ucount = df.groupby("uid")["iid"].nunique()
    icount = df.groupby("iid")["uid"].nunique()
    df = df[df["uid"].map(ucount) >= min_items]
    df = df[df["iid"].map(icount) >= min_users]
    return df


def drop_duplicate_pairs(df: pd.DataFrame) -> pd.DataFrame:
    """The reference's ``-sort-dup`` semantics (process_data.py:27):
    ``df.drop_duplicates(['uid', 'iid'])`` on the chronologically-sorted
    frame — keep only the FIRST interaction of every (uid, iid) pair,
    wherever the repeats fall in the sequence."""
    df = df.sort_values(["uid", "timestamp"], kind="stable")
    return df[~df.duplicated(["uid", "iid"], keep="first")]


def collapse_consecutive_duplicates(df: pd.DataFrame) -> pd.DataFrame:
    """Stricter alternative dedup (NOT the reference's): drop only rows
    repeating the immediately-previous item within a user's sequence, so
    genuine re-visits later in the history survive."""
    df = df.sort_values(["uid", "timestamp"], kind="stable")
    same = (df["uid"].values[1:] == df["uid"].values[:-1]) & \
        (df["iid"].values[1:] == df["iid"].values[:-1])
    keep = np.r_[True, ~same]
    return df[keep]


def leave_one_out_split(df: pd.DataFrame):
    """(train_df, test_df): last interaction per user held out."""
    df = df.sort_values(["uid", "timestamp"], kind="stable")
    last = df.groupby("uid").tail(1)
    train = df.drop(last.index)
    return train, last


def write_rating_files(df: pd.DataFrame, out_dir: str, name: str,
                       reindex: bool = True, dedup=False,
                       num_negatives: int = 0, seed: int = 2019) -> None:
    """Produce ``<name>.train.rating`` / ``<name>.test.rating`` (and, with
    ``num_negatives > 0``, the matching ``<name>.test.negative``).

    ``dedup``: False = keep every interaction (``-sort``); True or
    ``"pairs"`` = the reference's ``-sort-dup`` (global first-occurrence
    per (uid, iid), process_data.py:27); ``"consecutive"`` = collapse only
    immediate repeats (non-reference opt-in).
    """
    df = df.copy()
    if "rating" not in df.columns:
        df["rating"] = 1
    if "timestamp" not in df.columns:
        df["timestamp"] = np.arange(len(df), dtype=np.int64)
    if reindex:
        df["uid"] = df["uid"].astype("category").cat.codes.values
        df["iid"] = df["iid"].astype("category").cat.codes.values
    if dedup == "consecutive":
        df = collapse_consecutive_duplicates(df)
    elif dedup:
        df = drop_duplicate_pairs(df)
    train, test = leave_one_out_split(df)
    os.makedirs(out_dir, exist_ok=True)
    cols = ["uid", "iid", "rating", "timestamp"]
    train[cols].to_csv(os.path.join(out_dir, f"{name}.train.rating"),
                       sep="\t", header=False, index=False)
    test[cols].to_csv(os.path.join(out_dir, f"{name}.test.rating"),
                      sep="\t", header=False, index=False)
    if num_negatives:
        write_negative_file(train, test, out_dir, name,
                            num_negatives=num_negatives, seed=seed)


def write_negative_file(train: pd.DataFrame, test: pd.DataFrame,
                        out_dir: str, name: str, num_negatives: int = 100,
                        seed: int = 2019) -> None:
    """Write the HeDataset ``<name>.test.negative`` format the sampled-eval
    protocol consumes (reference Dataset.py:161-172; loaded back by
    ``datasets._load_negative_file``): one line per test user in test-file
    order, ``(u,gt)`` head field, then ``num_negatives`` tab-separated item
    ids sampled uniformly (without replacement) from the items the user
    never interacted with. Ids are written raw (0-based); the presplit
    loader applies its +1 pad shift on read, same as for the rating files.
    """
    num_items = int(max(train["iid"].max(), test["iid"].max())) + 1
    seen = {u: set(g) for u, g in train.groupby("uid")["iid"]}
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.test.negative"), "w") as f:
        for u, gt in zip(test["uid"].values, test["iid"].values):
            banned = seen.get(u, set()) | {int(gt)}
            if num_items - len(banned) < num_negatives:
                raise ValueError(
                    f"user {u}: only {num_items - len(banned)} candidate "
                    f"negatives for {num_negatives} requested")
            negs = []
            while len(negs) < num_negatives:
                draw = rng.integers(0, num_items, size=2 * num_negatives)
                for i in draw.tolist():  # sequential: no within-batch dupes
                    if i not in banned:
                        negs.append(i)
                        banned.add(i)
                        if len(negs) == num_negatives:
                            break
            f.write("(%d,%d)\t%s\n" % (
                u, gt, "\t".join(str(i) for i in negs)))
