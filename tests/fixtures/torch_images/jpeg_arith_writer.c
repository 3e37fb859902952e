/* Write an arithmetic-coded JPEG (SOF9, or SOF10 when progressive) of raw
 * samples with the system's libjpeg, which PIL cannot write:
 *
 *   cc jpeg_arith_writer.c -ljpeg -o jpeg_arith_writer
 *   jpeg_arith_writer IN OUT WIDTH HEIGHT SPACE [KEY=VALUE ...]
 *
 * IN holds HEIGHT x WIDTH pixels of interleaved 8-bit samples: 1 for SPACE
 * gray, 3 (RGB) for ycc (written as YCbCr with a JFIF marker), 4 for cmyk
 * (Adobe's transform 0) and ycck (Adobe's transform 2). The keys:
 *
 *   q=Q          quality (default 75)
 *   s=HxV,...    sampling factors, one per component (default libjpeg's)
 *   ri=N         restart interval in MCUs (default 0, none)
 *   prog=1       libjpeg's simple progression script
 *   scans=S;...  a progression script, each scan C,C,...:Ss:Se:Ah:Al
 *   dc=L,U       conditioning of every DC table (DAC; default 0,1)
 *   ac=K         conditioning of every AC table (DAC; default 5)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

static void usage(const char *why) {
  fprintf(stderr, "jpeg_arith_writer: %s\n", why);
  exit(2);
}

int main(int argc, char **argv) {
  if (argc < 6) usage("IN OUT WIDTH HEIGHT SPACE [KEY=VALUE ...]");
  const int width = atoi(argv[3]), height = atoi(argv[4]);
  const char *space = argv[5];
  int channels;
  J_COLOR_SPACE in_space, jpeg_space;
  if (!strcmp(space, "gray")) {
    channels = 1; in_space = JCS_GRAYSCALE; jpeg_space = JCS_GRAYSCALE;
  } else if (!strcmp(space, "ycc")) {
    channels = 3; in_space = JCS_RGB; jpeg_space = JCS_YCbCr;
  } else if (!strcmp(space, "cmyk")) {
    channels = 4; in_space = JCS_CMYK; jpeg_space = JCS_CMYK;
  } else if (!strcmp(space, "ycck")) {
    channels = 4; in_space = JCS_CMYK; jpeg_space = JCS_YCCK;
  } else {
    usage("SPACE is gray, ycc, cmyk or ycck");
  }
  const size_t row_bytes = (size_t)width * channels;
  unsigned char *pixels = malloc(row_bytes * height);
  FILE *in = fopen(argv[1], "rb");
  if (!in || fread(pixels, 1, row_bytes * height, in) != row_bytes * height)
    usage("cannot read the samples");
  fclose(in);

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = channels;
  cinfo.in_color_space = in_space;
  jpeg_set_defaults(&cinfo);
  jpeg_set_colorspace(&cinfo, jpeg_space);
  cinfo.arith_code = TRUE;

  static jpeg_scan_info scans[64];
  for (int i = 6; i < argc; ++i) {
    char *eq = strchr(argv[i], '=');
    if (!eq) usage("options are KEY=VALUE");
    *eq = '\0';
    const char *key = argv[i], *val = eq + 1;
    if (!strcmp(key, "q")) {
      jpeg_set_quality(&cinfo, atoi(val), TRUE);
    } else if (!strcmp(key, "s")) {
      for (int c = 0; c < channels; ++c) {
        int h, v, n;
        if (sscanf(val, "%dx%d%n", &h, &v, &n) != 2)
          usage("s=HxV,... needs one factor pair per component");
        cinfo.comp_info[c].h_samp_factor = h;
        cinfo.comp_info[c].v_samp_factor = v;
        val += n + (val[n] == ',');
      }
    } else if (!strcmp(key, "ri")) {
      cinfo.restart_interval = (unsigned)atoi(val);
    } else if (!strcmp(key, "prog")) {
      if (atoi(val)) jpeg_simple_progression(&cinfo);
    } else if (!strcmp(key, "scans")) {
      int n = 0;
      char *copy = strdup(val), *save = NULL;
      for (char *scan = strtok_r(copy, ";", &save); scan;
           scan = strtok_r(NULL, ";", &save)) {
        if (n == 64) usage("more than 64 scans");
        jpeg_scan_info *s = &scans[n++];
        char *comps = scan, *rest = strchr(scan, ':');
        if (!rest) usage("a scan is C,C,...:Ss:Se:Ah:Al");
        *rest++ = '\0';
        s->comps_in_scan = 0;
        for (char *c = strtok(comps, ","); c; c = strtok(NULL, ","))
          s->component_index[s->comps_in_scan++] = atoi(c);
        if (sscanf(rest, "%d:%d:%d:%d", &s->Ss, &s->Se, &s->Ah, &s->Al) != 4)
          usage("a scan is C,C,...:Ss:Se:Ah:Al");
      }
      free(copy);
      cinfo.scan_info = scans;
      cinfo.num_scans = n;
    } else if (!strcmp(key, "dc")) {
      int l, u;
      if (sscanf(val, "%d,%d", &l, &u) != 2) usage("dc=L,U");
      for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
        cinfo.arith_dc_L[t] = (UINT8)l;
        cinfo.arith_dc_U[t] = (UINT8)u;
      }
    } else if (!strcmp(key, "ac")) {
      for (int t = 0; t < NUM_ARITH_TBLS; ++t)
        cinfo.arith_ac_K[t] = (UINT8)atoi(val);
    } else {
      usage("unknown option");
    }
  }

  FILE *out = fopen(argv[2], "wb");
  if (!out) usage("cannot write the output");
  jpeg_stdio_dest(&cinfo, out);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pixels + cinfo.next_scanline * row_bytes;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pixels);
  return 0;
}
