"""Regenerate the shipped FakeTown2 map assets under configs/data/.

The reference's routing scenarios build their navigation graph from a live
CARLA server's topology (path_planner.py:210-574); headless, the shipped
``routed_town`` scenario replays a serialized capture instead.  This tool
produces that capture from the deterministic multi-road fake town fixture
(tests/fake_carla.Town2Map):

* ``town2_navgraph.npz``   -- NavGraph built by routing/carla_graph.py
  (waypoint_distance=10 m, jaywalking_weight_factor=2.0, matching the
  route-parity tests)
* ``town2_sidewalks.npz``  -- sidewalk border extraction (env/borders.py
  semantics via bridge/extract.py), the reference's sidewalk .npz cache
  format

Run: python tools/make_town2_assets.py   (pure numpy; no accelerator needed)
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main():
    import numpy as np
    import fake_carla
    from carla_social_force_model_tpu.routing.carla_graph import (
        build_carla_nav_graph)

    out_dir = os.path.join(REPO, "configs", "data")
    os.makedirs(out_dir, exist_ok=True)

    fmap = fake_carla.install_town2()  # registers the fake ``carla`` module
    graph = build_carla_nav_graph(fmap, waypoint_distance=10.0,
                                  jaywalking_weight_factor=2.0)
    path = os.path.join(out_dir, "town2_navgraph.npz")
    graph.save_npz(path)
    print(f"{path}: {graph.num_nodes} nodes, {len(graph.edge_u)} edges, "
          f"types {sorted(set(graph.edge_type.tolist()))}")

    # full sidewalk border extraction (the shipped town2_sidewalks.npz keeps
    # its original road-1-south-only capture for the sidewalk_counterflow
    # scenario; routed_town uses this full-town variant).  "lengths" is the
    # ragged point-count index used by arrays_to_ragged; section lengths in
    # meters (the reference's coarse-filter radius) go in "section_lengths".
    from carla_social_force_model_tpu.bridge.extract import extract_sidewalk
    lines, centers, lengths = extract_sidewalk(fmap, resolution=0.1)
    from carla_social_force_model_tpu.env import cache as _cache
    arrays = _cache.ragged_to_arrays(lines)
    arrays["centers"] = np.asarray(centers, np.float64)
    arrays["section_lengths"] = np.asarray(lengths, np.float64)
    arrays["resolution"] = np.float64(0.1)
    sw_path = os.path.join(out_dir, "town2_sidewalks_full.npz")
    np.savez_compressed(sw_path, **arrays)
    print(f"{sw_path}: {len(lines)} border lines, "
          f"{sum(len(l) for l in lines)} points")

    # sidewalk_counterflow capture: road 1's south sidewalk only (centerline
    # y = -7.5, borders at y = -6 and -9), as the scenario documents.  The
    # previously shipped file was written through the pre-fix cache path and
    # carried a corrupted ragged index (section meters where point counts
    # belong), mis-splitting the flat array into phantom diagonal walls.
    keep, kcent, klen = [], [], []
    for line, c, ln in zip(lines, centers, lengths):
        pts = np.asarray(line)
        if pts.size and np.all((pts[:, 1] >= -9.5) & (pts[:, 1] <= -5.5)) \
                and np.all((pts[:, 0] >= -1.0) & (pts[:, 0] <= 45.0)):
            keep.append(pts)
            kcent.append(c)
            klen.append(ln)
    arrays = _cache.ragged_to_arrays(keep)
    arrays["centers"] = np.asarray(kcent, np.float64)
    arrays["section_lengths"] = np.asarray(klen, np.float64)
    arrays["resolution"] = np.float64(0.1)
    r1_path = os.path.join(out_dir, "town2_sidewalks.npz")
    np.savez_compressed(r1_path, **arrays)
    print(f"{r1_path}: {len(keep)} border lines, "
          f"{sum(len(l) for l in keep)} points")

    # driving-lane route graph for destination-routed vehicles (the
    # reference's BehaviorAgent mode headless; routing/driving.py).  Spawn
    # points are lane-center locations on the through roads (the fake
    # server's get_spawn_points stub only covers road 1; destination
    # scenarios want the whole town addressable).
    from carla_social_force_model_tpu.routing.driving import (
        build_carla_driving_graph)
    dgraph = build_carla_driving_graph(fmap, waypoint_distance=4.0)
    # map-edge entries as origins, far road ends / the bend as destinations
    # (the fixture's road 5 is not split at its T-junction, so its
    # northbound lane is only enterable at the southern map edge -- same
    # fixture artifact as the overlapping borders noted below)
    sp = []
    for rid, s_frac, lane in [(1, 0.1, -1), (2, 0.9, -1), (3, 0.1, -1),
                              (4, 0.9, -1), (5, 0.1, -1), (6, 0.9, -1)]:
        road = fmap.roads[rid]
        wp = fake_carla.RoadWaypoint(road, lane, s_frac * road.length)
        tf = wp.transform
        sp.append(([tf.location.x, tf.location.y, tf.location.z],
                   np.radians(tf.rotation.yaw)))
    dgraph.spawn_xyz = np.asarray([p for p, _ in sp], np.float64)
    dgraph.spawn_yaw = np.asarray([y for _, y in sp], np.float64)
    dg_path = os.path.join(out_dir, "town2_driving.npz")
    dgraph.save_npz(dg_path)
    print(f"{dg_path}: {dgraph.num_nodes} nodes, {dgraph.num_edges} directed "
          f"edges, {len(sp)} spawn points")

    # NOTE: routed_town deliberately ships without these borders.  The
    # fixture's road footprints overlap at junctions (roads run up to the
    # junction edge while crossing roads' sidewalks pass through it), so the
    # extracted walls would cut across junction routes -- an artifact real
    # OpenDRIVE towns don't have.  sidewalk_counterflow uses the original
    # straight-corridor capture (town2_sidewalks.npz).


if __name__ == "__main__":
    main()
