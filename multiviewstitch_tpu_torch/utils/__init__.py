"""Debug dumps, numeric checks and metrics of the port (numpy / torch)."""
