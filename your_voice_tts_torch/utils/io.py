"""Experiment folders (the JAX package's utils/io.py): a run's folder
named after the run, the date and the git commit it was made from; and
`count_parameters`."""

from __future__ import annotations

import datetime
import os
import subprocess


def get_git_commit() -> str:
    """The short hash of the checkout this package lives in, or "unknown"
    outside a git checkout."""
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, check=True,
                              cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def create_experiment_folder(root_path: str, run_name: str) -> str:
    """Make and return <root_path>/<run_name>-<date>-<commit>."""
    date_str = datetime.datetime.now().strftime("%B-%d-%Y_%I+%M%p")
    out = os.path.join(root_path, f"{run_name}-{date_str}-{get_git_commit()}")
    os.makedirs(out, exist_ok=True)
    return out


def count_parameters(model) -> int:
    """The number of parameter elements of a torch module."""
    return int(sum(p.numel() for p in model.parameters()))
