"""Append-only text output protocol, format-compatible with the reference
(a copy of ``acf_tpu/utils/io.py``, which the port does not import).

The reference logs every epoch line to ``out/<opath>/<runName>.out`` and the
best epoch's per-user HR/NDCG vectors to ``.hr``/``.ndcg`` files
(reference utils.py:18-32). Kept byte-compatible so downstream tooling that
parsed the reference's logs keeps working.
"""

from __future__ import annotations

import os
from typing import Optional


def write2file(path: str, name: str, output: str, echo: bool = True) -> None:
    """Print a line and append it to ``path/name`` (reference utils.py:18-24)."""
    if echo:
        print(output)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "a") as f:
        f.write("%s\n" % output)


def prediction2file(path: str, name: str, pred) -> None:
    """One float per line (reference utils.py:26-32)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "w") as f:
        for item in pred:
            f.write("%f\n" % item)


class OutputWriter:
    """Bound (path, run-name) writer; with ``path=None`` it only prints."""

    def __init__(self, path: Optional[str], run_name: Optional[str],
                 quiet: bool = False):
        self.path = path
        self.run_name = run_name
        self.quiet = quiet

    def line(self, output: str) -> None:
        if self.path is None:
            if not self.quiet:
                print(output)
            return
        write2file(self.path, f"{self.run_name}.out", output,
                   echo=not self.quiet)

    def predictions(self, suffix: str, pred) -> None:
        if self.path is None:
            return
        prediction2file(self.path, f"{self.run_name}{suffix}", pred)


def init_logging(run_name: str, args=None, root: str = "Log") -> str:
    """Python-logging file setup (reference utils.py:270-277,
    evaluation_adv.py:489-496): a per-run file under ``Log/<date>/``,
    INFO level, with the argument namespace logged first. Returns the
    log-file path."""
    import logging
    from time import localtime, strftime

    path = os.path.join(root, strftime("%Y-%m-%d_%H", localtime()))
    os.makedirs(path, exist_ok=True)
    logfile = os.path.join(path, f"{run_name}.log")
    logging.basicConfig(filename=logfile, level=logging.INFO, force=True)
    if args is not None:
        logging.info(args)
    return logfile
