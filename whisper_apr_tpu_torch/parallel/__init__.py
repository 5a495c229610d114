"""Serving over a batch of slots (``serving.BatchScheduler``, on one
device or over a mesh), the (dp, tp) device mesh and its placements
(``mesh``), multi-host process groups (``distributed``) and the
multi-rank dry runs (``dryrun``)."""
