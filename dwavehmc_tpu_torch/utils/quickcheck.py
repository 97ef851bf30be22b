"""Quick-tier gate of the entry points that write scan results (port of
``dwavehmc_tpu/utils/quickcheck.py``).

Before any work, ``batch_scan_T`` and ``batch_scan_beta`` run the port's
quick tier and refuse to go on if it fails, so that no result is written
from a red tree.  The JAX package's tier (``pytest -m quick``) needs its
``tests/conftest.py``, which imports JAX; the port's tier runs without it
(``--noconftest``): the card tests ``tests/test_torch_cuda.py`` and the
kernel launch geometry ``tests/test_torch_lorentzian_launch.py``.

``SKIP_QUICK_TESTS=1`` skips it.  Under several ranks only the process
whose ``RANK`` is unset or 0 runs it.
"""

from __future__ import annotations

import os
import subprocess
import sys

#: the tier, relative to the checkout's root
QUICK_TESTS = ("tests/test_torch_cuda.py",
               "tests/test_torch_lorentzian_launch.py")


def run_quick_suite(repo_root: str | None = None) -> None:
    """Run the quick tier in a pytest subprocess; ``SystemExit`` if it
    fails.  A no-op under ``SKIP_QUICK_TESTS=1`` and on ranks other than 0."""
    if os.environ.get("SKIP_QUICK_TESTS", "0") == "1":
        print("[quickcheck] SKIP_QUICK_TESTS=1 — skipping quick tier",
              file=sys.stderr)
        return
    if os.environ.get("RANK", "0") != "0":
        return
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    print("[quickcheck] running quick test tier (pytest --noconftest "
          + " ".join(QUICK_TESTS) + ") ...", file=sys.stderr)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-x",
         "-p", "no:cacheprovider", *QUICK_TESTS],
        cwd=repo_root)
    if proc.returncode != 0:
        sys.exit("[quickcheck] quick test tier FAILED — refusing to "
                 "produce artifacts from a red tree "
                 "(SKIP_QUICK_TESTS=1 to override)")
    print("[quickcheck] quick tier green", file=sys.stderr)
