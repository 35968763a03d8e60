"""Offline converters of raw AV2, nuScenes and Waymo logs into the
range-view corpus (the port's copy of the repository's ``converters/``,
on the port's own Feather reader and native library)."""
