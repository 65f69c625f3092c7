"""Stage orchestration (align) and synthetic fixtures."""
