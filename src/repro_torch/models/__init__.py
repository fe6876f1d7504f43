"""Models: the CNN block and the CNN vision frontend (the served path)."""
