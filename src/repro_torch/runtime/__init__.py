"""Runtimes of the port: the batched LM server (``server.py``)."""
