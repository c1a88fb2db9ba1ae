"""Application packs of the port."""
