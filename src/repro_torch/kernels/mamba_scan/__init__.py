"""ssm_scan IP family — the selective scan of a Mamba block: the f32
loop oracle and the hand-written recurrence kernel."""
