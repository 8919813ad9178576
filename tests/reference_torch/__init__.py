"""Plain PyTorch references the tests hold the port against."""
