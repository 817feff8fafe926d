"""Time the port's page decoders on the golden pages: each page of
``tests/golden/pages`` named (all of them by default) decoded by
``tdnet_torch.data.image.decode_image`` on both routes, ``--repeats``
times (``--dir``: the pages of another directory, such as the full-size
ones of ``tools/make_pages.py --full-size``); prints one JSON line a page
with the fastest and the median milliseconds a route (a route that
refuses the page is left out). It needs only the port and numpy, so it
runs on any host with the checkout, the card's too:

    python tools/time_page_decodes.py j2k_97.jp2 j2k_rpcl.j2k --repeats 3
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tdnet_torch.data.image import decode_image  # noqa: E402

PAGES = ROOT / "tests" / "golden" / "pages"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pages", nargs="*", help="file names under tests/golden/pages")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dir", type=Path, default=PAGES, help="the pages' directory")
    args = ap.parse_args(argv)
    names = args.pages or sorted(p.name for p in args.dir.iterdir() if p.name != "digests.json")
    for name in names:
        data = (args.dir / name).read_bytes()
        row = {"page": name, "bytes": len(data)}
        for route in ("pil", "cv2"):
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                try:
                    decode_image(data, route=route)
                except ValueError:
                    break
                times.append((time.perf_counter() - t0) * 1e3)
            if times:
                row[route] = {"min_ms": round(min(times), 3),
                              "median_ms": round(statistics.median(times), 3)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
