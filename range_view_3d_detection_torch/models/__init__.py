"""Detector modules: blocks, stems, backbone, heads, detector, decoder."""
