"""Training runtime, port of ``repro.runtime``: the straggler monitor
(``straggler``).  ``elastic`` and ``robust_agg`` are not ported yet
(``ROADMAP.md``)."""
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
