"""The model zoo of the port: the dense decoder family (``registry``)."""
