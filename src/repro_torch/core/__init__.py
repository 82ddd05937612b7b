"""LP5X-PIM hardware model: timing engine, controller, device, energy.

Only the spec dataclasses are re-exported; the facade lives in
``repro_torch.core.pimsim`` and is imported from there, so importing this
package never pulls in the planner.
"""
from .timing import SystemSpec, LpddrTimings, PimSpec, DEFAULT_SYSTEM  # noqa: F401
