"""Serving-side planners over the simulator facade."""
