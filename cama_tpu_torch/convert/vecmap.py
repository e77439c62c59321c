"""Vector map extraction: nuScenes map layers -> polyline instances in the
ego-centered patch frame.  Mirrors the reference VectorizedLocalMap
(dataset/nuscenes2clip.py:22-428) with its load-bearing quirks:

  * the query patch is an AXIS-ALIGNED box centered at patch_center, while
    rotation (-patch_angle) and translation use map_pose (the mid-trajectory
    ego xy), not the patch center (nuscenes2clip.py:305-306,369-371)
  * ped_crossing rings clip to a patch GROWN by 0.2 m, boundary rings to a
    patch SHRUNK by 0.2 m (nuscenes2clip.py:163,197,234)
  * exteriors are forced CW and interiors CCW before ring clipping
    (nuscenes2clip.py:174-176,209-211)
  * CLASS2LABEL: divider->0, ped_crossing->1, contours->2

Geometry runs on cama_tpu_torch.convert.geom (pure NumPy — shapely-free), with
map data supplied by an adapter exposing
    line_layer(location, layer)    -> [polyline [N, 2], ...]
    polygon_layer(location, layer) -> [(exterior [N, 2], [holes...]), ...]
(the nuScenes devkit adapter lives in cama_tpu_torch.convert.nuscenes).
The PyTorch port's own copy of cama_tpu/convert/vecmap.py.
"""
from __future__ import annotations

import numpy as np

from cama_tpu_torch.convert import geom

CLASS2LABEL = {
    "road_divider": 0,
    "lane_divider": 0,
    "ped_crossing": 1,
    "contours": 2,
    "others": -1,
}


def quaternion_yaw(q_wxyz):
    """Yaw of a wxyz quaternion, matching nuscenes.eval.common.utils
    (projects the rotated x-axis onto the xy plane)."""
    w, x, y, z = q_wxyz
    # rotate unit x-vector
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + w * z)
    return float(np.arctan2(vy, vx))


class VectorizedLocalMap:
    def __init__(
        self,
        map_source,
        patch_size,
        map_classes=("divider", "ped_crossing", "boundary"),
        line_classes=("road_divider", "lane_divider"),
        ped_crossing_classes=("ped_crossing",),
        contour_classes=("road_segment", "lane"),
        sample_dist=1,
        num_samples=250,
        padding=False,
        fixed_ptsnum_per_line=-1,
        padding_value=-10000,
    ):
        self.map_source = map_source
        self.patch_size = patch_size  # (h, w)
        self.vec_classes = list(map_classes)
        self.line_classes = list(line_classes)
        self.ped_crossing_classes = list(ped_crossing_classes)
        self.polygon_classes = list(contour_classes)
        self.sample_dist = sample_dist
        self.num_samples = num_samples
        self.padding = padding
        self.fixed_num = fixed_ptsnum_per_line
        self.padding_value = padding_value

    # ---------------- patch-frame extraction ----------------

    def _patch_bounds(self, patch_box):
        cx, cy, h, w = patch_box
        return cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2

    def _to_local(self, pts, map_pose, patch_angle):
        pts = geom.rotate_points(pts, -patch_angle, (map_pose[0], map_pose[1]))
        return geom.translate_points(pts, -map_pose[0], -map_pose[1])

    def get_divider_line(self, patch_box, map_pose, patch_angle, layer_name, location):
        lines = self.map_source.line_layer(location, layer_name)
        minx, miny, maxx, maxy = self._patch_bounds(patch_box)
        out = []
        for line in lines:
            pieces = geom.clip_polyline_to_box(line, minx, miny, maxx, maxy)
            pieces = [self._to_local(p, map_pose, patch_angle) for p in pieces]
            if pieces:
                out.append(pieces)  # one (multi)line entry per record
        return out

    def _clipped_polygons(self, patch_box, map_pose, patch_angle, layer_name, location):
        polys = self.map_source.polygon_layer(location, layer_name)
        minx, miny, maxx, maxy = self._patch_bounds(patch_box)
        out = []
        for ext, holes in polys:
            c_ext = geom.clip_polygon_to_box(ext, minx, miny, maxx, maxy)
            if c_ext is None:
                continue
            c_holes = []
            for h in holes:
                ch = geom.clip_polygon_to_box(h, minx, miny, maxx, maxy)
                if ch is not None:
                    c_holes.append(self._to_local(ch, map_pose, patch_angle))
            out.append((self._to_local(c_ext, map_pose, patch_angle), c_holes))
        return out

    def get_contour_line(self, patch_box, map_pose, patch_angle, layer_name, location):
        return self._clipped_polygons(patch_box, map_pose, patch_angle, layer_name, location)

    def get_ped_crossing_line(self, patch_box, map_pose, patch_angle, location):
        return self._clipped_polygons(patch_box, map_pose, patch_angle, "ped_crossing", location)

    def get_map_geom(self, patch_box, map_pose, patch_angle, layer_names, location):
        out = []
        for layer in layer_names:
            if layer in self.line_classes:
                out.append((layer, self.get_divider_line(patch_box, map_pose, patch_angle, layer, location)))
            elif layer in self.polygon_classes:
                out.append((layer, self.get_contour_line(patch_box, map_pose, patch_angle, layer, location)))
            elif layer in self.ped_crossing_classes:
                out.append((layer, self.get_ped_crossing_line(patch_box, map_pose, patch_angle, location)))
        return out

    # ---------------- instance building ----------------

    def line_geoms_to_instances(self, line_geom):
        """Each record's clipped pieces become separate LineString instances
        (nuscenes2clip.py:141-153,271-277)."""
        out = {}
        for layer, records in line_geom:
            inst = []
            for pieces in records:
                inst.extend(pieces)
            out[layer] = inst
        return out

    def _rings_to_instances(self, polygons, margin):
        """Union polygons, orient rings (ext CW, holes CCW), clip each ring as
        a closed polyline to the origin-centered local patch, linemerge."""
        max_x = self.patch_size[1] / 2
        max_y = self.patch_size[0] / 2
        minx, miny = -max_x + margin, -max_y + margin
        maxx, maxy = max_x - margin, max_y - margin
        unioned = geom.union_polygons(polygons)
        results = []
        for ext, holes in unioned:
            # reference: exterior forced CW, interiors forced CCW
            rings = [ext[::-1] if geom.is_ccw(ext) else ext]
            rings += [h if geom.is_ccw(h) else h[::-1] for h in holes]
            for ring in rings:
                closed = np.concatenate([ring, ring[:1]], axis=0)
                pieces = geom.clip_polyline_to_box(closed, minx, miny, maxx, maxy)
                results.extend(geom.linemerge(pieces))
        return results

    def ped_poly_geoms_to_instances(self, ped_geom):
        return self._rings_to_instances(ped_geom[0][1], margin=-0.2)

    def poly_geoms_to_instances(self, polygon_geom):
        polys = list(polygon_geom[0][1]) + list(polygon_geom[1][1])
        return self._rings_to_instances(polys, margin=0.2)

    def line_geoms_to_vectors(self, line_geom):
        """Sampled-point variant of line_geoms_to_instances
        (nuscenes2clip.py:263-269)."""
        out = {}
        for layer, records in line_geom:
            vecs = []
            for pieces in records:
                vecs.extend(self.sample_pts_from_line(p) for p in pieces)
            out[layer] = vecs
        return out

    def poly_geoms_to_vectors(self, polygon_geom):
        """Sampled-point variant of poly_geoms_to_instances
        (nuscenes2clip.py:155-190)."""
        return [self.sample_pts_from_line(l) for l in self.poly_geoms_to_instances(polygon_geom)]

    def ped_geoms_to_vectors(self, ped_geom):
        """Sampled-point variant of ped_poly_geoms_to_instances
        (nuscenes2clip.py:279-297)."""
        return [self.sample_pts_from_line(l) for l in self.ped_poly_geoms_to_instances(ped_geom)]

    def sample_pts_from_line(self, line):
        """Fixed-distance or fixed-count resampling (nuscenes2clip.py:401-428)."""
        line = np.asarray(line, dtype=np.float64)
        seg = np.linalg.norm(np.diff(line, axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        length = cum[-1]
        if self.fixed_num < 0:
            distances = np.arange(0, length, self.sample_dist)
        else:
            distances = np.linspace(0, length, self.fixed_num)
        xs = np.interp(distances, cum, line[:, 0])
        ys = np.interp(distances, cum, line[:, 1])
        sampled = np.stack([xs, ys], axis=-1)
        num_valid = len(sampled)
        if not self.padding or self.fixed_num > 0:
            return sampled, num_valid
        if num_valid < self.num_samples:
            pad = np.zeros((self.num_samples - num_valid, 2))
            sampled = np.concatenate([sampled, pad], axis=0)
        else:
            sampled = sampled[: self.num_samples]
            num_valid = self.num_samples
        return sampled, num_valid

    # ---------------- top level ----------------

    def gen_vectorized_samples(self, location, lidar2global_translation,
                               lidar2global_rotation, patch_size, patch_center):
        patch_box = (patch_center[0], patch_center[1], patch_size[0], patch_size[1])
        map_pose = np.asarray(lidar2global_translation, dtype=np.float64)[:2]
        patch_angle = quaternion_yaw(lidar2global_rotation) / np.pi * 180

        vectors = []
        for vec_class in self.vec_classes:
            if vec_class == "divider":
                line_geom = self.get_map_geom(patch_box, map_pose, patch_angle,
                                              self.line_classes, location)
                for line_type, instances in self.line_geoms_to_instances(line_geom).items():
                    for instance in instances:
                        vectors.append((instance, CLASS2LABEL.get(line_type, -1)))
            elif vec_class == "ped_crossing":
                ped_geom = self.get_map_geom(patch_box, map_pose, patch_angle,
                                             self.ped_crossing_classes, location)
                for instance in self.ped_poly_geoms_to_instances(ped_geom):
                    vectors.append((instance, CLASS2LABEL.get("ped_crossing", -1)))
            elif vec_class == "boundary":
                polygon_geom = self.get_map_geom(patch_box, map_pose, patch_angle,
                                                 self.polygon_classes, location)
                for contour in self.poly_geoms_to_instances(polygon_geom):
                    vectors.append((contour, CLASS2LABEL.get("contours", -1)))
            else:
                raise ValueError(f"WRONG vec_class: {vec_class}")

        gt_instance, gt_labels = [], []
        for instance, label in vectors:
            if label != -1:
                gt_instance.append(instance)
                gt_labels.append(label)
        return {"gt_vecs_pts_loc": gt_instance, "gt_vecs_label": gt_labels}
