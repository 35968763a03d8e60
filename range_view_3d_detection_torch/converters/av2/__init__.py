"""AV2 sensor logs -> range-view Feather corpus."""
