"""Run provenance: code snapshot (port of dldkd_tpu/utils/provenance.py;
reference make_zipfile, config.py:145-150)."""

from __future__ import annotations

import os
import zipfile


def make_code_zip(src_dir: str, zip_path: str,
                  exclude_dirs=("results", "debug_results", "__pycache__",
                                ".git", "tests", "_build"),
                  exclude_exts=(".pyc", ".ipynb", ".swap", ".so")) -> None:
    """Zip the source tree under src_dir (the port's package; built
    kernel libraries left out) into zip_path."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(src_dir):
            dirs[:] = [d for d in dirs if d not in exclude_dirs]
            for fn in files:
                if any(fn.endswith(e) for e in exclude_exts):
                    continue
                full = os.path.join(root, fn)
                zf.write(full, os.path.join("code",
                                            os.path.relpath(full, src_dir)))
