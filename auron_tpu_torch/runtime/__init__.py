"""Task runtime: resources, planner and the task entry points."""
