#!/usr/bin/env python3
"""Copy standard input to standard output, each line prefixed with the
seconds since this script started, so a run's log shows where its wall
went:

    python3 -u chip_smoke.py 2>&1 | python3 tools/stamp_lines.py > run.log
"""

import sys
import time


def main() -> int:
    t0 = time.monotonic()
    for line in sys.stdin:
        sys.stdout.write(f"{time.monotonic() - t0:9.2f} {line}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
