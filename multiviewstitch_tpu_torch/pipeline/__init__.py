"""Stage orchestration (align, view-graph refinement), on-disk ingest and
synthetic fixtures."""
