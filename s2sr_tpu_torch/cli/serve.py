"""CLI: run the port's HTTP API server, its jobs on the card.

Usage: python -m s2sr_tpu_torch.cli.serve
(host, port, data and weights directories from the settings' environment
variables or ``.env``: SERVER_HOST, SERVER_PORT, DATA_DIR, WEIGHTS_DIR)
"""
from ..server.app import start_server

if __name__ == "__main__":
    start_server()
