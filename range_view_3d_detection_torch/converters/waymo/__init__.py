"""Waymo Open -> range-view Feather corpus."""
