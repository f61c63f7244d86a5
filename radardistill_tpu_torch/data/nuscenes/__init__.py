"""nuScenes evaluation of the port (the device-free metric only)."""
