from . import bending, collision, distance, integrate, spatial_hash, tet_volume
