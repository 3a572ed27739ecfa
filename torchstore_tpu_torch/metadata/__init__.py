"""The controller's metadata index."""
