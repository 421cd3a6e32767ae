"""The model zoo of the port: the dense decoder and ssm (mamba2) families
(``registry``)."""
