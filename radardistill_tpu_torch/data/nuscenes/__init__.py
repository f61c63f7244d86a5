"""nuScenes data of the port: the radar .pcd reader, the four datasets, the
info / GT-database generation and the evaluation bridge."""
