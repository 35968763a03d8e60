"""AV2 laser-number -> range-image-row calibration tables (the port's
copy of ``converters/av2/row_mappings.py``).

Sensor-geometry facts (beam elevation ordering of the AV2 up/down 32-beam
LiDAR pair), identical to the reference's hard-coded tables
(``src/torchbox3d/datasets/argoverse/constants.py:453-488`` and
``prototype/loader.py:62-129``): ``row = MAPPING[laser_number]`` sorts beams
by elevation so the range image is vertically ordered.
"""

import numpy as np

# 64-row mapping for the combined up+down LiDAR (loader.py:62-129).
ROW_MAPPING_64 = np.array(
    [
        56, 22, 42, 28, 61, 30, 49, 36, 40, 32, 38, 45, 34, 26, 53, 59,
        8, 1, 16, 20, 12, 5, 11, 15, 17, 9, 24, 6, 13, 3, 19, 0,
        7, 41, 21, 35, 2, 33, 14, 27, 23, 31, 25, 18, 29, 37, 10, 4,
        55, 62, 47, 43, 51, 58, 52, 48, 46, 54, 39, 57, 50, 60, 44, 63,
    ]
)

# 32-row mapping for the upper LiDAR only (constants.py:453-488).
ROW_MAPPING_32 = np.array(
    [
        29, 15, 25, 18, 31, 19, 27, 22, 24, 20, 23, 26, 21, 17, 28, 30,
        5, 1, 11, 14, 8, 3, 7, 10, 12, 6, 16, 4, 9, 2, 13, 0,
    ]
)
