"""The body template (its own numpy copy) and the 16-part labels."""
