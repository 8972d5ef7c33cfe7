"""Preprocess a raw nuScenes tree into the infos pickles and BEV map masks
the port's nuScenes readers take (port of ``tools/prepare_nuscenes.py``).

It reads the raw JSON tables directly (the annotation format is plain JSON,
so no devkit is needed):

  v1.0-<version>/{sample,sample_data,calibrated_sensor,ego_pose,sensor,
                  scene,log}.json
  maps/expansion/<location>.json      (optional; the map masks)

and writes under --data-root:

  nuscenes_infos_{train,val}.pkl: {"infos": [...]}, one dict per key frame
    (token, timestamp, lidar_path, sweeps [{data_path, sensor2lidar_rotation
    / translation, timestamp}], cams {CAM_X: {data_path, sensor2lidar_rotation
    / translation, camera_intrinsics}}, ego2global_rotation / translation,
    location): BEVFusion's schema, which ``data/bev_datasets.py:
    NuScenesBEVDataset`` and ``NuScenesFusionDataset`` read;
  maps_bev/<token>.npz: 'masks' [6, G, G] uint8 (drivable_area,
    ped_crossing, walkway, stop_line, carpark_area, divider), rasterised
    through Pillow in the ego frame over ±patch/2 m, row = x.

    python -m ddp_tpu_torch.tools.prepare_nuscenes --data-root data/nuscenes \
        [--version v1.0-mini] [--val-scenes scene-0103,scene-0916] \
        [--max-sweeps 10] [--grid 200] [--patch 102.4] [--skip-maps]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
        "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
MAP_CLASSES = ("drivable_area", "ped_crossing", "walkway", "stop_line",
               "carpark_area", "divider")


def quat_to_mat(q) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion → 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _pose_mat(rec) -> np.ndarray:
    """4x4 transform from a {rotation, translation} record."""
    m = np.eye(4)
    m[:3, :3] = quat_to_mat(rec["rotation"])
    m[:3, 3] = np.asarray(rec["translation"], np.float64)
    return m


def _load_tables(root: str, version: str):
    d = os.path.join(root, version)
    tables = {}
    for name in ("sample", "sample_data", "calibrated_sensor", "ego_pose",
                 "sensor", "scene", "log"):
        with open(os.path.join(d, f"{name}.json")) as f:
            rows = json.load(f)
        tables[name] = {r["token"]: r for r in rows}
    return tables


def _sensor_to_lidar(sd, lidar_sd, t):
    """sensor2lidar rotation+translation for sample_data ``sd`` relative to
    the key lidar frame (chain: sensor→ego(t_s)→global→ego(t_l)→lidar)."""
    cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
    ep = t["ego_pose"][sd["ego_pose_token"]]
    lcs = t["calibrated_sensor"][lidar_sd["calibrated_sensor_token"]]
    lep = t["ego_pose"][lidar_sd["ego_pose_token"]]
    g_from_s = _pose_mat(ep) @ _pose_mat(cs)
    g_from_l = _pose_mat(lep) @ _pose_mat(lcs)
    l_from_s = np.linalg.inv(g_from_l) @ g_from_s
    return l_from_s[:3, :3], l_from_s[:3, 3]


def build_infos(root: str, version: str, max_sweeps: int = 10):
    """The key frames that have a lidar sweep and all six cameras, in time
    order, as BEVFusion's info dicts, and each one's scene name."""
    t = _load_tables(root, version)
    # group sample_data by sample and channel
    by_sample = {}
    for sd in t["sample_data"].values():
        ch = t["sensor"][t["calibrated_sensor"][
            sd["calibrated_sensor_token"]]["sensor_token"]]["channel"]
        if sd["is_key_frame"]:
            by_sample.setdefault(sd["sample_token"], {})[ch] = sd

    infos, scene_of = [], {}
    for sample in sorted(t["sample"].values(), key=lambda s: s["timestamp"]):
        key = by_sample.get(sample["token"], {})
        if "LIDAR_TOP" not in key:
            continue
        lidar_sd = key["LIDAR_TOP"]
        info = {
            "token": sample["token"],
            "timestamp": sample["timestamp"],
            "lidar_path": lidar_sd["filename"],
            "cams": {},
            "sweeps": [],
        }
        ok = True
        for cam in CAMS:
            if cam not in key:
                ok = False
                break
            sd = key[cam]
            rot, trans = _sensor_to_lidar(sd, lidar_sd, t)
            cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
            info["cams"][cam] = {
                "data_path": sd["filename"],
                "sensor2lidar_rotation": rot,
                "sensor2lidar_translation": trans,
                "camera_intrinsics": np.asarray(cs["camera_intrinsic"],
                                                np.float64),
            }
        if not ok:
            continue
        # prior non-keyframe lidar sweeps via prev links
        sd = t["sample_data"].get(lidar_sd["prev"] or "")
        while sd is not None and len(info["sweeps"]) < max_sweeps:
            if not sd["is_key_frame"]:
                rot, trans = _sensor_to_lidar(sd, lidar_sd, t)
                info["sweeps"].append({
                    "data_path": sd["filename"],
                    "sensor2lidar_rotation": rot,
                    "sensor2lidar_translation": trans,
                    "timestamp": sd["timestamp"],
                })
            sd = t["sample_data"].get(sd["prev"] or "")
        # ego pose of the key lidar frame, needed for map rasterization
        lep = t["ego_pose"][lidar_sd["ego_pose_token"]]
        info["ego2global_rotation"] = np.asarray(lep["rotation"])
        info["ego2global_translation"] = np.asarray(lep["translation"])
        scene = t["scene"][sample["scene_token"]]
        scene_of[sample["token"]] = scene["name"]
        info["location"] = t["log"][scene["log_token"]].get("location", "")
        infos.append(info)
    return infos, scene_of


# ---------------------------------------------------------------- map masks
def _resolve_polygon(map_json, poly_token):
    nodes = map_json["_nodes"]
    poly = map_json["_polygons"].get(poly_token)
    if poly is None:
        return None
    ext = [nodes[nt] for nt in poly["exterior_node_tokens"]]
    holes = [[nodes[nt] for nt in h["node_tokens"]]
             for h in poly.get("holes", [])]
    return ext, holes


def _layer_geoms(map_json, layer):
    """Yield ('poly', exterior, holes) or ('line', pts) for a map layer."""
    nodes = map_json["_nodes"]
    for rec in map_json.get(layer, []):
        if "polygon_tokens" in rec:  # drivable_area: multipolygon
            for pt in rec["polygon_tokens"]:
                g = _resolve_polygon(map_json, pt)
                if g:
                    yield ("poly",) + g
        elif "polygon_token" in rec:
            g = _resolve_polygon(map_json, rec["polygon_token"])
            if g:
                yield ("poly",) + g
        elif "node_tokens" in rec:
            yield "line", [nodes[nt] for nt in rec["node_tokens"]], None
        elif "line_token" in rec:
            line = map_json["_lines"].get(rec["line_token"])
            if line:
                yield "line", [nodes[nt] for nt in line["node_tokens"]], None


def load_map(root: str, location: str):
    """The map expansion JSON of ``location`` with its node, polygon and
    line tables indexed by token, or None where there is none."""
    path = os.path.join(root, "maps", "expansion", f"{location}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        m = json.load(f)
    m["_nodes"] = {n["token"]: (n["x"], n["y"]) for n in m.get("node", [])}
    m["_polygons"] = {p["token"]: p for p in m.get("polygon", [])}
    m["_lines"] = {l["token"]: l for l in m.get("line", [])}
    return m


def rasterize_masks(map_json, ego_rot_quat, ego_trans, grid: int,
                    patch: float) -> np.ndarray:
    """[6, grid, grid] uint8 masks in the ego frame; mask[x_idx, y_idx]
    (the model's BEV convention: first axis = x)."""
    from PIL import Image, ImageDraw

    rot = quat_to_mat(ego_rot_quat)
    yaw = np.arctan2(rot[1, 0], rot[0, 0])
    c, s = np.cos(-yaw), np.sin(-yaw)
    ex, ey = float(ego_trans[0]), float(ego_trans[1])
    half = patch / 2.0
    scale = grid / patch

    def to_px(pts):
        # global -> ego (rotate by -yaw) -> pixel; PIL x = ego x, y = ego y
        out = []
        for gx, gy in pts:
            dx, dy = gx - ex, gy - ey
            exr = c * dx - s * dy
            eyr = s * dx + c * dy
            out.append(((exr + half) * scale, (eyr + half) * scale))
        return out

    masks = np.zeros((len(MAP_CLASSES), grid, grid), np.uint8)
    layer_sets = {"drivable_area": ("drivable_area",),
                  "ped_crossing": ("ped_crossing",),
                  "walkway": ("walkway",),
                  "stop_line": ("stop_line",),
                  "carpark_area": ("carpark_area",),
                  "divider": ("road_divider", "lane_divider")}
    for ci, cls in enumerate(MAP_CLASSES):
        im = Image.new("L", (grid, grid), 0)
        draw = ImageDraw.Draw(im)
        for layer in layer_sets[cls]:
            for kind, a, holes in _layer_geoms(map_json, layer):
                if kind == "poly":
                    if len(a) >= 3:
                        draw.polygon(to_px(a), fill=1)
                    for h in holes or []:
                        if len(h) >= 3:
                            draw.polygon(to_px(h), fill=0)
                else:
                    if len(a) >= 2:
                        draw.line(to_px(a), fill=1, width=1)
        # PIL arrays are [y, x]; transpose to the model's [x, y] convention
        masks[ci] = np.asarray(im, np.uint8).T
    return masks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="nuScenes raw tables -> infos pkl + BEV masks")
    p.add_argument("--data-root", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--val-scenes", default="",
                   help="comma-separated scene names for the val split "
                        "(default: everything goes to train)")
    p.add_argument("--max-sweeps", type=int, default=10)
    p.add_argument("--grid", type=int, default=200)
    p.add_argument("--patch", type=float, default=102.4,
                   help="map patch side in meters (matches xbound +-51.2)")
    p.add_argument("--skip-maps", action="store_true")
    args = p.parse_args(argv)

    infos, scene_of = build_infos(args.data_root, args.version, args.max_sweeps)
    print(f"{len(infos)} keyframe samples")

    if not args.skip_maps:
        os.makedirs(os.path.join(args.data_root, "maps_bev"), exist_ok=True)
        maps = {}
        n_masks = 0
        for info in infos:
            loc = info.get("location", "")
            if loc not in maps:
                maps[loc] = load_map(args.data_root, loc)
            if maps[loc] is None:
                continue
            masks = rasterize_masks(maps[loc], info["ego2global_rotation"],
                                    info["ego2global_translation"], args.grid, args.patch)
            np.savez_compressed(os.path.join(args.data_root, "maps_bev", f"{info['token']}.npz"),
                                masks=masks)
            n_masks += 1
        print(f"rasterized {n_masks} map masks "
              f"({len([m for m in maps.values() if m])} locations)")

    val_scenes = set(s for s in args.val_scenes.split(",") if s)
    splits = {"train": [], "val": []}
    for info in infos:
        splits["val" if scene_of[info["token"]] in val_scenes else "train"].append(info)
    for split, rows in splits.items():
        path = os.path.join(args.data_root, f"nuscenes_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"infos": rows}, f)
        print(f"wrote {path} ({len(rows)} samples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
