"""The plain reference of what the timed path produces.

NumPy and plain PyTorch only: it reads the clip files the generator wrote
(attribute.json, odometry, label maps, height grid, camera JPEGs, ground
truth PNGs) and works out again, from those alone, the lifted 3-D labels,
the interpolated poses, the projection with its crop, the painted overlay
on the undistorted base images and the map-evaluation sums.  It imports
nothing of the program under test.  `dtype` selects the precision of the
projection chain: float64 for the reference, bfloat16 for the control.
"""
