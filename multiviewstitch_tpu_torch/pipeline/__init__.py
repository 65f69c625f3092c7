"""Stage orchestration (align), on-disk ingest and synthetic fixtures."""
