"""Run-directory helpers: the TSV file logger and config IO (a copy of
``gcn_tpu.train.logger``).

Mirrors the reference's ``utils/helper.py`` (FileLogger at ``:49-64``,
config IO at ``:28-47``) so tooling that parses ``logs.txt`` reads either
package's runs.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def ensure_dir(d: str, verbose: bool = True) -> None:
    if not os.path.exists(d):
        if verbose:
            print(f"Directory {d} does not exist; creating...")
        os.makedirs(d, exist_ok=True)


def save_config(config: dict, path: str, verbose: bool = True) -> dict:
    with open(path, "w") as f:
        json.dump(config, f, indent=2, default=list)
    if verbose:
        print(f"Config saved to file {path}")
    return config


def load_config(path: str, verbose: bool = True) -> dict:
    with open(path) as f:
        config = json.load(f)
    if verbose:
        print(f"Config loaded from file {path}")
    return config


def print_config(config: dict) -> None:
    info = "Running with the following configs:\n"
    for k, v in config.items():
        info += f"\t{k} : {v}\n"
    print("\n" + info + "\n")


class FileLogger:
    """Append-per-line log file; truncates any existing file at
    construction, unless ``append`` (a resumed run keeps its history and
    writes no second header)."""

    def __init__(self, filename: str, header: Optional[str] = None,
                 append: bool = False):
        self.filename = filename
        if append and os.path.exists(filename):
            return
        if os.path.exists(filename):
            os.remove(filename)
        if header is not None:
            with open(filename, "w") as out:
                print(header, file=out)

    def log(self, message: str) -> None:
        with open(self.filename, "a") as out:
            print(message, file=out)
