"""Entry points: the Bebop-RPC inference server (``serve``)."""
