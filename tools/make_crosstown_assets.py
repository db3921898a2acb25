"""Regenerate the shipped CrossTown map assets under configs/data/.

CrossTown (tests/fake_carla.CrossTownMap) is the junction-faithful fixture:
roads are split at the junction polygon like real OpenDRIVE, so the full
sidewalk-border extraction coexists with routing over junction corners and
crosswalks -- the ``routed_town_walled`` scenario class.  (Town2Map's
overlapping road footprints made that impossible; see make_town2_assets.py.)

* ``crosstown_navgraph.npz``   -- NavGraph built by routing/carla_graph.py
  (waypoint_distance=10 m, jaywalking_weight_factor=2.0)
* ``crosstown_sidewalks.npz``  -- full sidewalk border extraction
  (env/borders.py semantics via bridge/extract.py), the reference's
  sidewalk .npz cache format (obstacles.py:27-64)

Run: python tools/make_crosstown_assets.py   (pure numpy; no accelerator needed)
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
    from carla_social_force_model_tpu.bridge.extract import extract_sidewalk
    from carla_social_force_model_tpu.env import cache as _cache

    out_dir = os.path.join(REPO, "configs", "data")
    os.makedirs(out_dir, exist_ok=True)

    fmap = fake_carla.install_crosstown()
    graph = build_carla_nav_graph(fmap, waypoint_distance=10.0,
                                  jaywalking_weight_factor=2.0)
    path = os.path.join(out_dir, "crosstown_navgraph.npz")
    graph.save_npz(path)
    print(f"{path}: {graph.num_nodes} nodes, {len(graph.edge_u)} edges, "
          f"types {sorted(set(graph.edge_type.tolist()))}")

    lines, centers, lengths = extract_sidewalk(fmap, resolution=0.1)
    arrays = _cache.ragged_to_arrays(lines)
    arrays["centers"] = np.asarray(centers, np.float64)
    arrays["section_lengths"] = np.asarray(lengths, np.float64)
    arrays["resolution"] = np.float64(0.1)
    sw_path = os.path.join(out_dir, "crosstown_sidewalks.npz")
    np.savez_compressed(sw_path, **arrays)
    print(f"{sw_path}: {len(lines)} border lines, "
          f"{sum(len(l) for l in lines)} points")


if __name__ == "__main__":
    main()
