"""``python -m repro_torch.fleet``: a JSON-lines fleet service on stdio.

Lives here (not under ``if __name__`` in :mod:`repro_torch.fleet.api`)
because running the api module itself with ``-m`` would execute it twice,
once as ``repro_torch.fleet.api`` through the package import and once as
``__main__``, and register its ``FLEET_BACKENDS`` entries twice.
"""
import sys

from .api import main

if __name__ == "__main__":
    sys.exit(main())
