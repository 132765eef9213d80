"""Process supervision of the port: the fleet reconciler
(``launcher/reconciler.py``), which keeps the serving hosts alive."""
