"""Run the HTTP service (reference deployment: uvicorn app.main:app on 8080,
reference backend/Dockerfile:29)."""

import argparse

from ..serve import serve_forever
from . import configure_logging


def main():
    parser = argparse.ArgumentParser(description="Serve the document-QA API.")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args()
    configure_logging()
    serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
