"""Models of the port: the dense decoder family (``transformer``) on plain
torch primitives (``layers``)."""
