"""Fabric, queue sizing and owner routing on virtual shards."""
