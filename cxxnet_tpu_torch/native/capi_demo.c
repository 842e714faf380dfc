/*
 * C ABI smoke driver of the PyTorch port: train a tiny MLP from plain C
 * through the embedded interpreter (cxxnet_tpu_torch/native/capi.cc).
 * Exercises CXNNetCreate/SetParam/InitModel/UpdateBatch/PredictBatch/
 * SaveModel/LoadModel/GetWeight.  Exit 0 when the reloaded net predicts
 * the synthetic rule (argmax accuracy > 0.9).
 *
 *   capi_demo [device [model_path]]     (defaults: gpu, capi_demo.model)
 */
#include "capi.h"

#include <stdio.h>
#include <stdlib.h>

#define BATCH 64
#define DIM 16
#define NCLASS 4

static const char *kNetCfg =
    "netconfig=start\n"
    "layer[0->1] = fullc:fc1\n"
    "  nhidden = 32\n"
    "layer[1->2] = relu\n"
    "layer[2->3] = fullc:fc2\n"
    "  nhidden = 4\n"
    "layer[3->3] = softmax\n"
    "netconfig=end\n"
    "input_shape = 1,1,16\n"
    "batch_size = 64\n"
    "updater = sgd\n"
    "eta = 0.1\n";

static void fill_batch(float *data, float *label, unsigned seed) {
  /* class = argmax of 4 disjoint feature blocks */
  unsigned s = seed * 2654435761u + 12345u;
  for (int i = 0; i < BATCH; ++i) {
    int cls = (s = s * 1103515245u + 12345u) >> 16 & (NCLASS - 1);
    for (int j = 0; j < DIM; ++j) {
      float noise = ((s = s * 1103515245u + 12345u) >> 16 & 1023) / 1024.0f;
      data[i * DIM + j] = 0.1f * noise + (j / (DIM / NCLASS) == cls ? 1.f : 0.f);
    }
    label[i] = (float)cls;
  }
}

int main(int argc, char **argv) {
  const char *dev = argc > 1 ? argv[1] : "gpu";
  const char *path = argc > 2 ? argv[2] : "capi_demo.model";
  void *net = CXNNetCreate(dev, kNetCfg);
  if (net == NULL) {
    fprintf(stderr, "create failed: %s\n", CXNGetLastError());
    return 1;
  }
  if (CXNNetInitModel(net) != 0) {
    fprintf(stderr, "init failed: %s\n", CXNGetLastError());
    return 1;
  }

  float data[BATCH * DIM], label[BATCH];
  cxx_ulong dshape[4] = {BATCH, 1, 1, DIM}, lshape[2] = {BATCH, 1};
  for (int step = 0; step < 60; ++step) {
    fill_batch(data, label, step);
    if (CXNNetUpdateBatch(net, data, dshape, 4, label, lshape, 2) != 0) {
      fprintf(stderr, "update failed: %s\n", CXNGetLastError());
      return 1;
    }
  }

  /* save -> reload -> predict */
  if (CXNNetSaveModel(net, path) != 0) {
    fprintf(stderr, "save failed: %s\n", CXNGetLastError());
    return 1;
  }
  char cfg2[64];
  snprintf(cfg2, sizeof(cfg2), "batch_size = %d\n", BATCH);
  void *net2 = CXNNetCreate(dev, cfg2);
  if (net2 == NULL || CXNNetLoadModel(net2, path) != 0) {
    fprintf(stderr, "reload failed: %s\n", CXNGetLastError());
    return 1;
  }

  cxx_ulong oshape[4];
  int ondim = 0;
  fill_batch(data, label, 999);
  const cxx_real_t *pred =
      CXNNetPredictBatch(net2, data, dshape, 4, oshape, &ondim);
  if (pred == NULL) {
    fprintf(stderr, "predict failed: %s\n", CXNGetLastError());
    return 1;
  }
  int correct = 0;
  for (int i = 0; i < BATCH; ++i)
    if ((int)pred[i] == (int)label[i]) ++correct;
  printf("capi_demo: %s accuracy %d/%d\n", dev, correct, BATCH);

  cxx_ulong wshape[4];
  int wndim = 0;
  const cxx_real_t *w = CXNNetGetWeight(net2, "fc1", "wmat", wshape, &wndim);
  if (w == NULL || wndim != 2 || wshape[0] != 32 || wshape[1] != DIM) {
    fprintf(stderr, "get_weight failed: %s\n", CXNGetLastError());
    return 1;
  }

  CXNNetFree(net2);
  CXNNetFree(net);
  CXNShutdown();
  return correct > BATCH * 9 / 10 ? 0 : 2;
}
