"""Helpers shared by the trainers and the serving plane
(:mod:`.profiling`)."""
