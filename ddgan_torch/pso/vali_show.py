"""Loss-log inspector: parse iteration-print logs, report G/D MAE/MSE
(reference: additionals/vali_show.py; the port's copy of
`ddgan_tpu/pso/vali_show.py`)."""

from __future__ import annotations

import numpy as np


class SimpleShow:
    """Parses lines like 'Epoch 1, Iteration 0, G Loss: 0.69, D Loss: 1.38'."""

    def __init__(self, losses: str, G: str = "G-Loss", D: str = "D-Loss"):
        lines = losses.split("\n")
        if lines:
            lines.pop(0)
        if lines:
            lines.pop()
        g_losses, d_losses = [], []
        for line in lines:
            for chunk in line.split(","):
                toks = chunk.split(" ")
                if "G" in toks:
                    g_losses.append(float(toks[toks.index("G") + 2]))
                elif "D" in toks:
                    d_losses.append(float(toks[toks.index("D") + 2]))
        self.G = g_losses
        self.D = d_losses

    def get_loss(self):
        g_mae = float(np.mean(np.abs(self.G)))
        g_mse = float(np.mean(np.square(self.G)))
        d_mae = float(np.mean(np.abs(self.D)))
        d_mse = float(np.mean(np.square(self.D)))
        return g_mae, g_mse, d_mae, d_mse

    def show(self):
        g_mae, g_mse, d_mae, d_mse = self.get_loss()
        print("The Mean Absolute Error of Generator is: ", g_mae)
        print("The Mean Squared Error of Generator is: ", g_mse)
        print("The Mean Absolute Error of Discriminator is: ", d_mae)
        print("The Mean Squared Error of Discriminator is: ", d_mse)
