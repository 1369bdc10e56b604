"""Launch drivers of the torch port (LM serving)."""
