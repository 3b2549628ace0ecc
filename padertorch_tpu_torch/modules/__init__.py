from padertorch_tpu_torch.modules.fully_connected import fully_connected_stack
from padertorch_tpu_torch.modules.recurrent import LSTM, GRU, StatefulLSTM
from padertorch_tpu_torch.modules.convnet import ConvNet
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
