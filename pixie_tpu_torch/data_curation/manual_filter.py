"""Manual data-filtering correction (manual_data_filtering_correction.py
equivalent; port of pixie_tpu/data_curation/manual_filter.py).

The reference ships a streamlit app (data_curation/
manual_data_filtering_correction.py, 273 LoC) where a human pages through
VLM-filtered object thumbnails and flips accept/reject decisions, writing
the corrected class assignments back into config/obj_ids_metadata.json.
Streamlit isn't part of this environment, so the same workflow is exposed as
a terminal tool with identical on-disk semantics:

  python -m pixie_tpu_torch.data_curation.manual_filter --metadata m.json list \
      [--obj-class metal_crates] [--status rejected]
  ... accept OBJ_ID [OBJ_ID ...]
  ... reject OBJ_ID [OBJ_ID ...] [--reason "..."]
  ... reclass OBJ_ID NEW_CLASS
  ... apply corrections.json           # batch: {obj_id: {...}} merge
  ... stats

Corrections are merged into the metadata file in place (atomic rewrite);
every mutation is also appended to a sidecar ``<metadata>.corrections.log``
JSONL for auditability — the streamlit app kept this history in
session_state only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _load(path: Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def _write_atomic(path: Path, data: dict) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(data, indent=2, sort_keys=True))
    tmp.replace(path)


def _log_mutation(path: Path, entry: dict) -> None:
    entry = dict(entry, ts=time.strftime("%Y-%m-%dT%H:%M:%S"))
    with path.open("a") as f:
        f.write(json.dumps(entry) + "\n")


def _entry(metadata: dict, obj_id: str) -> dict:
    cur = metadata.get(obj_id)
    if cur is None:
        return {}
    if isinstance(cur, str):  # legacy plain-class entries
        return {"obj_class": cur}
    return dict(cur)


def apply_correction(metadata: dict, obj_id: str, **fields) -> dict:
    """Merge correction fields into one object's entry; returns the entry."""
    e = _entry(metadata, obj_id)
    e.update({k: v for k, v in fields.items() if v is not None})
    metadata[obj_id] = e
    return e


def filter_objects(metadata: dict, obj_class: str | None = None,
                   status: str | None = None) -> dict:
    """status: accepted | rejected | unreviewed (matching the UI's tabs)."""
    out = {}
    for obj_id in sorted(metadata):
        e = _entry(metadata, obj_id)
        if obj_class and e.get("obj_class") != obj_class:
            continue
        acc = e.get("accepted")
        st = ("unreviewed" if acc is None
              else "accepted" if acc else "rejected")
        if status and st != status:
            continue
        out[obj_id] = e
    return out


def stats(metadata: dict) -> dict:
    per_class: dict[str, dict] = {}
    for obj_id in metadata:
        e = _entry(metadata, obj_id)
        c = e.get("obj_class", "?")
        s = per_class.setdefault(
            c, {"total": 0, "accepted": 0, "rejected": 0, "unreviewed": 0})
        s["total"] += 1
        acc = e.get("accepted")
        s["unreviewed" if acc is None else "accepted" if acc else "rejected"] += 1
    return per_class


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="manual_filter")
    ap.add_argument("--metadata", required=True,
                    help="obj_ids_metadata.json path")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list")
    p.add_argument("--obj-class")
    p.add_argument("--status", choices=["accepted", "rejected", "unreviewed"])

    p = sub.add_parser("accept")
    p.add_argument("obj_ids", nargs="+")

    p = sub.add_parser("reject")
    p.add_argument("obj_ids", nargs="+")
    p.add_argument("--reason", default=None)

    p = sub.add_parser("reclass")
    p.add_argument("obj_id")
    p.add_argument("new_class")

    p = sub.add_parser("apply")
    p.add_argument("corrections", help="JSON {obj_id: {accepted, obj_class, ...}}")

    sub.add_parser("stats")

    args = ap.parse_args(argv)
    meta_path = Path(args.metadata)
    metadata = _load(meta_path)
    log_path = meta_path.with_suffix(meta_path.suffix + ".corrections.log")

    if args.cmd == "list":
        sel = filter_objects(metadata, args.obj_class, args.status)
        for obj_id, e in sel.items():
            acc = e.get("accepted")
            st = "?" if acc is None else ("+" if acc else "-")
            print(f"{st} {obj_id}  {e.get('obj_class', '?')}"
                  + (f"  ({e['reason']})" if e.get("reason") else ""))
        print(f"{len(sel)} objects", file=sys.stderr)
        return 0

    if args.cmd == "stats":
        print(json.dumps(stats(metadata), indent=2, sort_keys=True))
        return 0

    if args.cmd == "accept":
        for obj_id in args.obj_ids:
            apply_correction(metadata, obj_id, accepted=True)
            _log_mutation(log_path, {"op": "accept", "obj_id": obj_id})
    elif args.cmd == "reject":
        for obj_id in args.obj_ids:
            apply_correction(metadata, obj_id, accepted=False,
                             reason=args.reason)
            _log_mutation(log_path, {"op": "reject", "obj_id": obj_id,
                                     "reason": args.reason})
    elif args.cmd == "reclass":
        apply_correction(metadata, args.obj_id, obj_class=args.new_class)
        _log_mutation(log_path, {"op": "reclass", "obj_id": args.obj_id,
                                 "new_class": args.new_class})
    elif args.cmd == "apply":
        corrections = json.loads(Path(args.corrections).read_text())
        for obj_id, fields in corrections.items():
            apply_correction(metadata, obj_id, **fields)
        _log_mutation(log_path, {"op": "apply", "n": len(corrections),
                                 "source": args.corrections})

    _write_atomic(meta_path, metadata)
    print(f"wrote {meta_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
