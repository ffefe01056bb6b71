# Copied from catch_tpu/utils/version.py.
"""Version lookup (parity: reference catch/utils/version.py)."""

import os
import subprocess

RELEASE_VERSION = "0.1.0"


def get_project_path():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def get_version():
    """git describe -> VERSION file -> RELEASE_VERSION fallback."""
    repo = os.path.join(get_project_path(), "..")
    try:
        out = subprocess.run(
            ["git", "describe", "--tags", "--dirty", "--always"],
            cwd=repo, capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    version_file = os.path.join(get_project_path(), "VERSION")
    if os.path.exists(version_file):
        with open(version_file) as f:
            return f.read().strip()
    return RELEASE_VERSION
