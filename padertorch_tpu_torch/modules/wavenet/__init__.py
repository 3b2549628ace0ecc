from padertorch_tpu_torch.modules.wavenet.wavenet import WaveNet, Conv
