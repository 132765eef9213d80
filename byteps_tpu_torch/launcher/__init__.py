"""Process supervision of the port: ``launch.py`` (bpslaunch, one worker
per GPU), ``dist_launcher.py`` (bpslaunch-dist, the ssh fan-out to
hosts, each running ``launch.py``) and ``reconciler.py`` (the fleet
reconciler, which keeps the serving hosts alive)."""
