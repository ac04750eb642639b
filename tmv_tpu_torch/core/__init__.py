"""Framework pieces the ported models need (so far: the ``Config`` container)."""
