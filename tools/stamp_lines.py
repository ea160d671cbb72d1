#!/usr/bin/env python3
"""Prefix each line of standard input with the seconds since the first
read, to see where a long script's wall time goes between its printed
lines:

    python3 -u chip_smoke.py 2>&1 | python3 tools/stamp_lines.py > run.log

The gap before a line is the time the script spent producing it.
"""
import sys
import time


def main():
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:8.2f} {line}")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
