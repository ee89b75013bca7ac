"""Graph-exporting conv models (``zoo.py`` registry)."""
