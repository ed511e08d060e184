#!/usr/bin/env python
"""Entry point, flag-compatible with the reference CLI: ``python main.py <flags>``."""
from dqgp.cli import main

if __name__ == "__main__":
    main()
