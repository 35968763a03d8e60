"""nuScenes -> range-view Feather corpus."""
