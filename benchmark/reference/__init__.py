"""Plain-torch references of the served model families (one file each)."""
