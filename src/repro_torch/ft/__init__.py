from repro_torch.ft.restart import RestartManager, StragglerWatchdog
