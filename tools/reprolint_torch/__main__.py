"""``python -m tools.reprolint_torch`` — the port's static-analysis entry
point.  Puts ``src/`` on the path and hands off to
:func:`repro_torch.analysis.driver.main`; imports no jax.  Run from the
repo root::

    python -m tools.reprolint_torch --all          # CI: every rule
    python -m tools.reprolint_torch --ast          # source rules only (fast)
    python -m tools.reprolint_torch --run --program dif_altgdmin
"""
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(_ROOT / "src") not in sys.path:
    sys.path.insert(0, str(_ROOT / "src"))

from repro_torch.analysis.driver import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
