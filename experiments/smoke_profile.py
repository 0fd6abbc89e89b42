#!/usr/bin/env python3
"""Where chip_smoke.py's wall time goes, by a stack sampler on its main
thread.

    python3 experiments/smoke_profile.py OUT.txt [PHASES]

Runs `chip_smoke.main()` (PHASES as chip_smoke.py takes them, all by
default) while a thread samples the main thread's stack every 0.2 s, and
writes OUT.txt: the seconds spent under each chain of up to four calls
below `main` (the phases, then what they call), and the inclusive seconds
of each function of the repository. Sampling costs no measurable time; the
script's own output is chip_smoke.py's.
"""
from __future__ import annotations

import collections
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERIOD_S = 0.2


def main() -> int:
    out_path = sys.argv[1]
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")] + sys.argv[2:]
    import chip_smoke
    main_id = threading.get_ident()
    inclusive, chains = collections.Counter(), collections.Counter()
    stop = threading.Event()

    def sample():
        while not stop.wait(PERIOD_S):
            frame = sys._current_frames().get(main_id)
            names = []
            while frame is not None:
                path = frame.f_code.co_filename
                if path.startswith(ROOT + os.sep):
                    names.append(f"{os.path.relpath(path, ROOT)}:"
                                 f"{frame.f_code.co_name}")
                frame = frame.f_back
            names.reverse()
            for name in set(names):
                inclusive[name] += PERIOD_S
            if "chip_smoke.py:main" in names:
                below = names[names.index("chip_smoke.py:main") + 1:][:4]
                for depth in range(1, len(below) + 1):
                    chains[" > ".join(below[:depth])] += PERIOD_S
    threading.Thread(target=sample, daemon=True).start()
    try:
        return chip_smoke.main()
    finally:
        stop.set()
        with open(out_path, "w") as f:
            f.write("== under each call chain from main (s)\n")
            for chain, secs in chains.most_common():
                if secs >= 1.0:
                    f.write(f"{secs:8.1f}  {chain}\n")
            f.write("\n== inclusive (s)\n")
            for name, secs in inclusive.most_common(300):
                f.write(f"{secs:8.1f}  {name}\n")


if __name__ == "__main__":
    sys.exit(main())
